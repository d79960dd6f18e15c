"""GpuBatchedStorage — the GPU-resident storage backend (counterpart of
``ratelimiter_tpu/storage/tpu.py:TpuBatchedStorage``): the micro-batch
route and the stream routes.

Behind the ``RateLimitStorage`` plugin boundary, ``tryAcquire()`` calls are
micro-batched on the host (engine/batcher.py) and dispatched to counter
rows resident on the card (engine/engine.py), one fused step per batch,
with decisions bit-identical to ``semantics/oracle.py``.  Integer-key
streams take a stream route instead
(:meth:`GpuBatchedStorage.acquire_stream_ids`).  Unit permits take the
relay: per chunk the C slot index compacts the requests to one word per
unique slot, one device step decides every unique slot at once, and the
host rebuilds each request's decision; duplicate-poor chunks send one
word per request instead (words mode).  Small permits of one limiter take
the weighted relay; everything else the flat sorted step.

String-key streams (:meth:`GpuBatchedStorage.acquire_stream_strs`) take
the same routes, hashing each chunk's keys once.

The surface is the batched decision protocol: ``register_limiter``,
``set_policy`` (with ``add_policy_listener`` and ``policy_info``),
``acquire`` / ``acquire_async`` (one decision through the batcher),
``acquire_many`` / ``acquire_many_ids`` (one synchronous batch),
``acquire_stream_ids`` / ``acquire_stream_strs`` (a whole stream,
pipelined), ``available_many``, ``reset_key``, ``lease_reserve`` /
``lease_credit`` (one key's token-lease charge, ``leases/``), ``flush``
and ``close``.

Durability (``engine/checkpoint.py``, whose files the reference's
storage reads and writes too): ``save_checkpoint`` / ``restore_checkpoint``
for one geometry, ``export_keys`` / ``import_keys`` for any other, and
``promote_from_replica`` for a standby's index.  Fencing: ``fence`` /
``lift_fence`` / ``fence_info`` / ``lease_scope_epoch`` and the serving
lease (``grant_serving_lease``, ``release_serving_lease``,
``serving_lease_info``); every decision surface, the lease calls
included, refuses with ``FencedError`` while fenced or once the serving
lease ran out, and with ``PromotionInProgressError`` while a promotion
rebuilds the index.

The host slot index is the reference's: one C index with one LRU, or,
on tables of 2^16 slots and more on hosts with more than two cores, the
partitioned index (``engine/partitioned.py``: T sub-indexes walked in
parallel, LRU per partition), elected by :func:`elect_host_parallel` as
the reference's storage elects it; ``host_parallel=`` overrides the
election.  ``checkpointable=True`` takes the keyed Python index instead
(``engine/slots.py``), whose exports carry the keys, so they import into
any geometry; its streams go in synchronous batches, as the reference's
do.

The host-side legacy counter and script contract of ``RateLimitStorage``
(``increment_and_expire`` ... ``eval_script``) goes to an embedded
``InMemoryStorage``, as in the reference: it never touches the card.

Observability, as the reference's (``observability=False`` turns it off):
the ``ratelimiter.storage.latency`` timer and a ``DecisionTrace`` record
(``trace``) per drained micro batch and stream chunk, the stream stage
timers ``ratelimiter.stream.{route,pack,index,layout,enqueue,fetch}``,
the ``ratelimiter.time.backward_clamp`` counter, the flight recorder's
slow-dispatch anomaly past ``obs_slo_ms``, the request-lifecycle
histograms ``ratelimiter.latency.*`` (``observability/trace.py``, with
1-in-``trace_sample`` full traces), the fleet telemetry plane
(``telemetry``: the ``ratelimiter.decisions.*`` counters and the
per-tenant usage ring) and the trace-id lineage ring (``lineage``).
Policy listeners (``add_policy_listener``) hear every ``set_policy``
after the row moved.

Admission control, as the reference's: ``max_pending`` bounds each
algorithm's pending micro-batch queue and ``queue_deadline_ms`` gives
each request a queue budget (``engine/batcher.py``); a shed raises
``OverloadedError`` from ``acquire``.

``serving_cache=True`` puts the hybrid host-side serving tier
(``cache/hybrid.py``) in front of ``acquire_async``; it is off by
default.

The storage runs on the card: ``device=None`` resolves to ``cuda`` and
raises when no CUDA device is present.  Pass ``device="cpu"`` to run the
same code on the CPU (the kernels' plain versions serve CPU tensors).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ratelimiter_tpu_torch.core.config import RateLimitConfig
from ratelimiter_tpu_torch.engine import checkpoint as ckpt
from ratelimiter_tpu_torch.engine.batcher import MicroBatcher
from ratelimiter_tpu_torch.engine.engine import DeviceEngine
from ratelimiter_tpu_torch.engine.errors import OverloadedError
from ratelimiter_tpu_torch.engine.flush_control import AdaptiveFlushController
from ratelimiter_tpu_torch.engine.native_index import (
    NativeSlotIndex,
    hash_str_keys,
    rebuild_words_into,
    relay_decide,
    sort_uniques,
    weighted_decide,
    weighted_layout,
)
from ratelimiter_tpu_torch.engine.partitioned import PartitionedSlotIndex
from ratelimiter_tpu_torch.engine.routing import (
    shard_of_int_keys,
    shard_of_key,
)
from ratelimiter_tpu_torch.engine.slots import SlotIndex
from ratelimiter_tpu_torch.engine.state import LimiterTable
from ratelimiter_tpu_torch.metrics import MeterRegistry
from ratelimiter_tpu_torch.ops.relay import wire_costs
from ratelimiter_tpu_torch.storage.base import RateLimitStorage
from ratelimiter_tpu_torch.storage.errors import (
    FencedError,
    PromotionInProgressError,
)
from ratelimiter_tpu_torch.storage.memory import InMemoryStorage
from ratelimiter_tpu_torch.utils.logging import get_logger
from ratelimiter_tpu_torch.utils.tracing import DecisionTrace

log = get_logger("storage.gpu")


# Relay stream chunking (the reference's schedule, storage/tpu.py:70-84):
# the first chunk is _RELAY_CHUNK requests; each later chunk grows toward
# the digest wire budget at the bytes per request the previous chunk
# measured, capped at _RELAY_CHUNK_MAX.  Zipf traffic compacts harder in
# bigger chunks, so skewed streams grow to a few giant chunks.
_RELAY_CHUNK = 1 << 19
_RELAY_CHUNK_MAX = 1 << 24
_RELAY_WIRE_BUDGET_DIGEST = 16 << 20
_RELAY_WIRE_BUDGET_WORDS = 16 << 20
# The relay's per-chunk election charges the resident digest's (slot, lid)
# uploads at a quarter of their bytes: a pair is paid once and then serves
# every later chunk that touches the slot, so a pass where every lid is
# fresh still elects the digest and reaches its steady state (the
# reference's amortization).
_DELTA_AMORT = 4
# The resident digest's (slot, lid) pairs go up padded to a power of two,
# at least this many.
_DELTA_FLOOR = 8
# At or above this many uniques the C index sorts a chunk's uniques by
# slot, so the device step walks the state rows in address order.
_SORT_UNIQUES_MIN = 1 << 12
# The weighted relay's chunks grow toward their own wire budget (the
# reference's), by the same schedule.
_RELAY_WIRE_BUDGET_WEIGHTED = 48 << 20
# Deepest segment (requests of one key in a chunk) the weighted relay's
# rank-major scan takes; a deeper chunk goes through the flat step.
_WREL_MAX_R = 64
# Lane cap of one flat sorted step: a chunk or super-batch past it runs as
# flat steps (weighted fallback) or K-step scans (flat path) of this size.
_FLAT_MAX_LANES = 1 << 19
# The partitioned host index's election (the reference's constants): from
# this many slots, min(cores, _HOST_PARALLEL_AUTO_MAX) partitions.
_HOST_PARALLEL_AUTO_MIN_SLOTS = 1 << 16
_HOST_PARALLEL_AUTO_MAX = 8


def elect_host_parallel(num_slots: int, checkpointable: bool = False) -> int:
    """The partition count the reference's storage elects for the host
    slot index (``TpuBatchedStorage._auto_host_parallel``): 0 (one index)
    under ``checkpointable`` (the keyed index), below
    ``_HOST_PARALLEL_AUTO_MIN_SLOTS`` slots or on a host of at most two
    cores (``os.sched_getaffinity``), else min(cores,
    ``_HOST_PARALLEL_AUTO_MAX``) walked down to the largest count that
    divides ``num_slots`` (0 when that reaches 1).

    The reference's other conditions hold by construction here: the port
    has no sharded engine, and its C index builds or raises, where the
    reference elects 0 when its library did not load."""
    if checkpointable or num_slots < _HOST_PARALLEL_AUTO_MIN_SLOTS:
        return 0
    try:
        cores = len(os.sched_getaffinity(0))
    except (AttributeError, OSError):  # not Linux
        cores = os.cpu_count() or 1
    if cores <= 2:
        return 0
    t = min(cores, _HOST_PARALLEL_AUTO_MAX)
    while t > 1 and num_slots % t:
        t -= 1
    return t if t > 1 else 0


def _bucket_fine(n: int, floor: int = 4096) -> int:
    """Quarter-octave bucketing (the reference's): the next multiple of
    octave / 4 at or above ``n``, and at least ``floor``.  It sizes the
    weighted relay's padded lanes."""
    if n <= floor:
        return floor
    step = 1 << (int(n - 1).bit_length() - 3)
    return -(-n // step) * step


def _elect_digest(u: int, n: int, n_delta: int, digest_bpu: float,
                  words_bpr: float) -> bool:
    """The relay's per-chunk mode, as the reference elects it without a
    link profile: the digest (``u`` unique words, ``n_delta`` padded lid
    pairs charged at 1 / ``_DELTA_AMORT``) when it ships no more bytes
    than words mode's ``n`` per-request words."""
    return digest_bpu * u + 8 * n_delta / _DELTA_AMORT <= words_bpr * n


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
        max_inflight: int = 4,
        max_pending: int = 0,
        queue_deadline_ms: float = 0.0,
        clock_ms: Callable[[], int] = _wall_clock_ms,
        meter_registry: MeterRegistry | None = None,
        device=None,
        host_parallel: int | None = None,
        checkpointable: bool = False,
        trace_sample: int = 0,
        obs_slo_ms: float = 0.0,
        observability: bool = True,
        recorder=None,
        adaptive_flush: bool = True,
        flush_floor_ms: float = 0.05,
        serving_cache: bool = False,
        serving_cache_ttl_ms: float = 50.0,
        serving_cache_max_keys: int = 65536,
        serving_cache_unconfirmed_cap: int = 64,
        serving_cache_guard_ms: float = 5.0,
        usage_max_tenants: int = 256,
        telemetry_max_clients: int = 1024,
        lineage_capacity: int = 256,
        table_capacity: int = 0,
    ):
        self.device = resolve_device(device)
        self._clock_ms = clock_ms
        # The storage's meters (the reference's): a storage built without
        # a registry gets a private one unless observability is off.
        self._obs = bool(observability)
        if meter_registry is None and self._obs:
            meter_registry = MeterRegistry()
        self.registry = meter_registry
        self._recorder = None
        self._latency = None
        self._stage_timers = None
        if self._obs:
            from ratelimiter_tpu_torch.observability import flight_recorder

            self._recorder = (recorder if recorder is not None
                              else flight_recorder())
            if obs_slo_ms and obs_slo_ms > 0:
                self._recorder.set_slo_ms(obs_slo_ms)
            # Per-dispatch wall time, dispatch to fetched results.
            self._latency = meter_registry.timer(
                "ratelimiter.storage.latency",
                "Device dispatch latency (per micro-batch)")
            # Where a stream chunk's seconds go: pack (string hashing),
            # index (slot walk), layout (host dispatch prep), enqueue
            # (device dispatch call), fetch (the blocking result read).
            # ``route`` belongs to the sharded engine's host routing.
            self._stage_timers = {
                st: meter_registry.timer(
                    f"ratelimiter.stream.{st}",
                    f"Stream pipeline {st} stage (us per chunk)")
                for st in ("route", "pack", "index", "layout", "enqueue",
                           "fetch")}
        self.trace = DecisionTrace()
        # Fleet telemetry plane (observability/telemetry.py): the
        # ratelimiter.decisions.* counters and the per-tenant usage ring,
        # fed from micro drains, stream chunks, sheds and degraded
        # decisions; and the trace-id lineage ring that sampled ids
        # record their hops in.  The request-lifecycle tracer aggregates
        # the batcher's stamps into the ratelimiter.latency.* histograms
        # and samples 1-in-trace_sample full traces into ``trace``.
        self.telemetry = None
        self.lineage = None
        self._tracer = None
        if self._obs:
            from ratelimiter_tpu_torch.observability import (
                LatencyTracer,
                TelemetryPlane,
                TraceLineage,
            )

            self.telemetry = TelemetryPlane(
                meter_registry, clock_ms=clock_ms,
                max_clients=telemetry_max_clients)
            self.telemetry.usage.max_tenants = max(int(usage_max_tenants),
                                                   1)
            self.lineage = TraceLineage(capacity=lineage_capacity,
                                        sample_n=int(trace_sample))
            self._tracer = LatencyTracer(
                meter_registry, trace=self.trace,
                sample_n=int(trace_sample), recorder=self._recorder,
                lineage=self.lineage)
        # The legacy counter/script contract (host-side).
        self._host = InMemoryStorage(clock_ms=clock_ms)
        # Parties holding a policy-derived mirror (the degraded host
        # limiter) hear (lid, algo, config, generation) after the row
        # moved; the hybrid tier is told inline, before it.
        self._policy_listeners: List[Callable] = []
        # table_capacity pre-sizes the policy table (rows); 0 keeps the
        # table's default.
        self.table = LimiterTable(
            capacity=table_capacity if table_capacity > 0 else 64,
            device=self.device)
        self.engine = DeviceEngine(num_slots, self.table, device=self.device)
        self._configs: Dict[int, Tuple[str, RateLimitConfig]] = {}
        # The host slot index, one per algorithm: partitioned over
        # host_parallel sub-indexes when that is above 1 (None elects the
        # count as the reference does, 0 turns partitions off); the keyed
        # index under checkpointable=True, whose dumps carry the keys.
        if host_parallel is None:
            host_parallel = elect_host_parallel(num_slots, checkpointable)
        self._host_parallel = (int(host_parallel)
                               if host_parallel and host_parallel > 1 else 0)
        if self._host_parallel and checkpointable:
            raise ValueError(
                "host_parallel requires fingerprint checkpoints; it cannot "
                "combine with checkpointable=True (which needs the keyed "
                "Python index)")
        if self._host_parallel and num_slots % self._host_parallel:
            raise ValueError(
                f"num_slots ({num_slots}) must divide evenly by "
                f"host_parallel ({self._host_parallel})")

        def make_index():
            if checkpointable:
                return SlotIndex(num_slots)
            if self._host_parallel:
                return PartitionedSlotIndex(num_slots, self._host_parallel)
            return NativeSlotIndex(num_slots)
        self._index = {"sw": make_index(), "tb": make_index()}
        # Standby promotion window: decisions are refused (typed,
        # retryable) while promote_from_replica swaps the indexes.
        self._promoting = False
        # Fencing: a monotonic epoch installed before a replacement starts
        # serving.  _fence_all refuses every decision; _fenced_shards
        # scopes a fence to shards of a sharded engine (the port has none,
        # so a scoped fence refuses nothing here).  Token leases revoke
        # against lease_scope_epoch: _shard_fence_epochs is a per-shard
        # ratchet that lift_fence never clears, _full_fence_epoch moves
        # only on whole-storage fences.
        self._fence_epoch = 0
        self._fence_all = False
        self._fenced_shards: frozenset = frozenset()
        self.fence_rejected = 0
        self._shard_fence_epochs: Dict[int, int] = {}
        self._full_fence_epoch = 0
        # The serving lease: the right to decide at an epoch until a
        # deadline on this storage's clock (0 = none installed).  The
        # first decision past the deadline self-fences.
        self._lease_epoch = 0
        self._lease_deadline_ms = 0
        self.lease_self_fenced = False
        # Per-chunk host timings of the last stream call.
        self.last_stream_chunks: List[dict] = []
        # Which slots' limiter ids the engine's lid map holds, per
        # algorithm (allocated by the first resident digest).  A clear
        # marks its slots unknown under the algorithm's lock, which the
        # resident digest holds from reading the marks to setting them,
        # so a clear racing a dispatch forces a later re-upload.
        self._lid_known: Dict[str, np.ndarray] = {}
        self._lid_locks = {"sw": threading.Lock(), "tb": threading.Lock()}
        # Batch timestamps are clamped monotonically non-decreasing: a wall
        # clock stepping backwards must not roll windows backwards (the
        # slot rows keep only the curr and prev buckets).  Each absorbed
        # regression is counted.
        self._last_stamp = 0
        self._stamp_lock = threading.Lock()
        self.backward_clamps = 0
        self._backward_clamp_counter = (
            meter_registry.counter(
                "ratelimiter.time.backward_clamp",
                "Wall-clock regressions absorbed by the monotonic batch-"
                "timestamp clamp")
            if meter_registry is not None else None)

        def _stamp() -> int:
            with self._stamp_lock:
                now = self._clock_ms()
                if now < self._last_stamp:
                    self.backward_clamps += 1
                    if self._backward_clamp_counter is not None:
                        self._backward_clamp_counter.increment()
                else:
                    self._last_stamp = now
                return self._last_stamp

        self._monotonic_now = _stamp

        # Hybrid host-side serving tier (cache/hybrid.py): answers hot
        # repeat-reject and safely-under-limit keys host-side from exact
        # adopted per-key state, device-confirmed asynchronously.  Off by
        # default; None costs one falsy check per acquire.
        self._serving = None
        if serving_cache:
            from ratelimiter_tpu_torch.cache.hybrid import HybridServingCache

            self._serving = HybridServingCache(
                clock_ms=lambda: self._monotonic_now(),
                ttl_ms=serving_cache_ttl_ms,
                max_keys=serving_cache_max_keys,
                unconfirmed_cap=serving_cache_unconfirmed_cap,
                guard_ms=serving_cache_guard_ms,
                registry=meter_registry if self._obs else None,
            )

        # Dispatch/drain split (engine + batcher): the flusher only
        # enqueues device work and the drainers copy results back, so
        # several batches can be in flight.  The list surface
        # (dispatch_direct) and the staged surface (the flusher's
        # pre-packed buffer) return the same fused tensor, so one drain
        # per algo serves both.  The handle carries the dispatch's start
        # time, its stamp and a copy of its lid lanes to the drain: the
        # latency meter reads the first, the hybrid tier adopts state at
        # the second, the telemetry plane counts per tenant from the
        # third (the staging buffer recycles once the drain completes, so
        # the drain must not hold a view of it).
        def _dispatcher(fn):
            def run(s, l, p):
                stamp = _stamp()
                return (fn(s, l, p, stamp), time.perf_counter(), stamp,
                        np.asarray(l, dtype=np.int64))

            return run

        def _staged_dispatcher(algo):
            def run(buf, n):
                tracer = self._tracer
                t0 = time.perf_counter()
                stamp = _stamp()
                buf[3, 0] = stamp
                t1 = time.perf_counter()
                handle = self.engine.micro_staged_dispatch(algo, buf, n)
                if tracer is not None:
                    t2 = time.perf_counter()
                    tracer.record_sub("pack", (t1 - t0) * 1e6)
                    tracer.record_sub("layout", (t2 - t1) * 1e6)
                return (handle, t1, stamp, buf[1, :n].copy())

            return run

        def _drainer(algo):
            def run(handle_t0, n):
                handle, t0, stamp, lids = handle_t0
                out = self.engine.micro_staged_drain(algo, handle, n)
                self._record_dispatch(algo, n, int(out["allowed"].sum()),
                                      (time.perf_counter() - t0) * 1e6)
                if self.telemetry is not None:
                    # Per-tenant fleet accounting: one bincount pass per
                    # batch, never per decision.
                    self.telemetry.note_batch(lids, out["allowed"],
                                              now_ms=stamp)
                if self._serving is not None:
                    out["stamp"] = np.full(n, stamp, dtype=np.int64)
                return out

            return run

        # Adaptive flush control (engine/flush_control.py): the applied
        # deadline and size trigger track the measured step time, clamped
        # within [flush_floor_ms, max_delay_ms] and [32, max_batch].
        controller = AdaptiveFlushController(
            base_delay_ms=max_delay_ms,
            floor_ms=min(flush_floor_ms, max_delay_ms)
            if max_delay_ms > 0 else flush_floor_ms,
            cap_ms=max(max_delay_ms, flush_floor_ms),
            size_floor=32,
            size_cap=max_batch,
            meter_registry=meter_registry if self._obs else None,
        ) if adaptive_flush else None
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
            max_inflight=max_inflight,
            max_pending=max_pending,
            deadline_ms=queue_deadline_ms,
            controller=controller,
            meter_registry=meter_registry,
            tracer=self._tracer,
            recorder=self._recorder,
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
        if self._serving is not None:
            self._serving.register(lid, algo, config)
        return lid

    def set_policy(self, lid: int, config: RateLimitConfig,
                   generation: int | None = None) -> int:
        """Live-update one limiter's policy; returns the policy generation
        the update installed.  Pending micro-batch traffic is flushed
        first, so every decision stamped before this call ran under the
        old row and every later one under the new.  The hybrid tier
        forgets the lid's adopted state before the row moves (a host
        serve racing the update must not answer from the old policy);
        policy listeners hear the update after it.  ``generation``
        installs another storage's stamp (a limiter dump applied by
        ``engine/checkpoint.py:apply_limiter_policies``) instead of
        bumping the local one."""
        entry = self._configs.get(int(lid))
        if entry is None:
            raise KeyError(f"no limiter registered under lid={lid}")
        algo, _old = entry
        config.validate()
        if self._serving is not None:
            self._serving.update_policy(int(lid), algo, config)
        self._batcher.flush()
        gen = self.table.set_policy(int(lid), config,
                                    generation=generation)
        self._configs[int(lid)] = (algo, config)
        for listener in self._policy_listeners:
            try:
                listener(int(lid), algo, config, gen)
            except Exception:  # noqa: BLE001 — a broken mirror must not
                # poison the actuation path; the listener logs itself.
                log.exception("policy listener failed for lid=%d", lid)
        return gen

    def add_policy_listener(self, listener) -> None:
        """Subscribe ``listener(lid, algo, config, generation)`` to live
        policy updates (called after the device row moved)."""
        self._policy_listeners.append(listener)

    def policy_info(self) -> Dict:
        """Policy-generation metadata: the table-wide monotonic generation
        plus each lid's row stamp and policy."""
        return {
            "generation": self.table.generation,
            "lids": {int(lid): {
                "algo": algo,
                "generation": self.table.row_generation(lid),
                "max_permits": cfg.max_permits,
                "window_ms": cfg.window_ms,
                "refill_rate": cfg.refill_rate,
            } for lid, (algo, cfg) in self._configs.items()},
        }

    def acquire(self, algo: str, lid: int, key: str, permits: int,
                deadline_ms: float | None = None,
                trace_id: int = 0) -> dict:
        """Single decision through the micro-batcher (blocks until the
        batch holding this request lands; bounded by max_delay_ms).

        ``deadline_ms`` overrides the storage-wide queue-deadline budget
        for this request (admission control; engine/batcher.py)."""
        return self.acquire_async(algo, lid, key, permits,
                                  deadline_ms=deadline_ms,
                                  trace_id=trace_id).result()

    def acquire_async(self, algo: str, lid: int, key: str, permits: int,
                      deadline_ms: float | None = None,
                      trace_id: int = 0):
        """Future-returning :meth:`acquire`: a caller may submit many
        before resolving any, so they coalesce into one flush.

        ``trace_id``: a 64-bit trace id carried end to end (0 = mint one
        here when lineage sampling is armed) — sampled ids record
        batcher/shard/resolve hops (observability/telemetry.py).  A shed
        (``OverloadedError``) is counted against the lid in the telemetry
        plane before it propagates.

        With the hybrid serving tier on, a tracked key's decision may
        resolve host-side at once (``cache/hybrid.py``): a pure reject
        touches no device at all; a mutating decision rides the next
        micro-batch as its device confirmation."""
        lin = self.lineage
        if not trace_id and lin is not None and lin.sample_n > 0:
            from ratelimiter_tpu_torch.observability.telemetry import (
                mint_trace_id,
            )

            trace_id = mint_trace_id()
        serving = self._serving
        if serving is not None:
            fut = self._serve_host_side(algo, lid, key, permits)
            if fut is not None:
                return fut
        t0 = time.perf_counter() if self._tracer is not None else 0.0
        slot = self._assign_slot(algo, lid, key, hold_pin=True)
        if self._tracer is not None:
            self._tracer.record_sub(
                "index", (time.perf_counter() - t0) * 1e6)
        # The pin (taken inside the assign) holds until the submit has
        # registered the slot in the batcher's pending set.
        try:
            with self._pins_released(self._index[algo], [slot]):
                fut = self._batcher.submit(algo, slot, lid, permits,
                                           deadline_ms=deadline_ms,
                                           trace_id=trace_id)
        except OverloadedError:
            if self.telemetry is not None:
                self.telemetry.note_shed(lid, 1)
            raise
        if serving is not None:
            serving.watch_miss(algo, lid, key, permits, slot, fut)
        return fut

    def _serve_host_side(self, algo: str, lid: int, key: str, permits: int):
        """Hybrid-tier serve attempt: a resolved Future, or None (miss).
        A host-served mutating decision is forwarded through the batcher
        under the tier's lock (so device order == serve order per key)
        and confirmed by its drain callback.  The fence and promotion
        checks run first: a host-served decision refuses where a device
        dispatch would."""
        self._check_not_promoting()
        if self._fenced_shards:
            self._check_fence_keys([lid], [key])
        serving = self._serving
        with serving.lock:
            served = serving.serve(algo, lid, key, permits)
            if served is None:
                return None
            out, predicted = served
            if predicted is not None:  # mutated host-side: confirm async
                slot = self._assign_slot(algo, lid, key, hold_pin=True)
                with self._pins_released(self._index[algo], [slot]):
                    cfut = self._batcher.submit(algo, slot, lid, permits)
                serving.watch_confirm(algo, lid, key, predicted, slot,
                                      cfut)
        fut: Future = Future()
        fut.set_result(out)
        return fut

    def acquire_async_many(self, algo: str, lid: int,
                           keys: Sequence[str], permits=None,
                           deadline_ms: float | None = None):
        """Bulk :meth:`acquire_async` for a pipelined burst sharing one
        limiter: the keys hash and map in one batched slot walk
        (``index.assign_batch_strs``), then submit in one vectorized
        staging-buffer write (``MicroBatcher.submit_many``).  Returns one
        Future per key; the decisions ride the next micro-batch flush
        together.  An index without ``assign_batch_strs`` (the keyed
        index) decides key by key through :meth:`acquire_async`.  The
        hybrid tier is bypassed (a burst wants coalescing, not per-key
        host serves)."""
        self._check_not_promoting()
        if self._fenced_shards:
            self._check_fence_keys([lid] * len(keys), keys)
        n = len(keys)
        if permits is None:
            permits = np.ones(n, dtype=np.int64)
        index = self._index[algo]
        if not hasattr(index, "assign_batch_strs"):
            return [self.acquire_async(algo, lid, k, int(p),
                                       deadline_ms=deadline_ms)
                    for k, p in zip(keys, permits)]
        t0 = time.perf_counter() if self._tracer is not None else 0.0
        with self._evictions_cleared(algo):
            slots, clears = index.assign_batch_strs(
                list(keys), lid,
                pinned=self._batcher.pending_slots(algo),
                hold_pins=True)
        if self._tracer is not None:
            self._tracer.record_sub(
                "index", (time.perf_counter() - t0) * 1e6)
        for evicted in clears:
            self._batcher.add_clear(algo, int(evicted))
        try:
            with self._pins_released(index, slots):
                return self._batcher.submit_many(
                    algo, slots, np.full(n, lid, dtype=np.int64), permits,
                    deadline_ms=deadline_ms)
        except OverloadedError:
            if self.telemetry is not None:
                self.telemetry.note_shed(lid, n)
            raise

    def acquire_async_block(self, algo: str, lid: int, data, offsets,
                            permits=None,
                            deadline_ms: float | None = None,
                            trace_id: int = 0):
        """Columnar :meth:`acquire_async_many`: the caller hands a v5 batch
        frame's key column verbatim (data uint8[klen] packed UTF-8 +
        offsets i64[n+1]) and gets ONE future resolving to
        ``{"allowed": bool[n], ...}`` lane slices, with no per-request
        Python objects on the way (``index.assign_batch_bytes`` ->
        ``MicroBatcher.submit_block``).  Returns None when this storage
        cannot take the columnar shortcut (an index without
        ``assign_batch_bytes``: the partitioned and the keyed ones, or
        shard fences that need the key strings); the caller then decodes
        the keys and takes the per-key path, with the same decisions."""
        self._check_not_promoting()
        if self._fenced_shards:
            return None  # fence checks need the decoded keys
        index = self._index[algo]
        if not hasattr(index, "assign_batch_bytes"):
            return None
        n = len(offsets) - 1
        if permits is None:
            permits = np.ones(n, dtype=np.int64)
        t0 = time.perf_counter() if self._tracer is not None else 0.0
        with self._evictions_cleared(algo):
            slots, clears = index.assign_batch_bytes(
                data, offsets, lid,
                pinned=self._batcher.pending_slots(algo),
                hold_pins=True)
        if self._tracer is not None:
            self._tracer.record_sub(
                "index", (time.perf_counter() - t0) * 1e6)
        for evicted in clears:
            self._batcher.add_clear(algo, int(evicted))
        try:
            with self._pins_released(index, slots):
                return self._batcher.submit_block(
                    algo, slots, np.full(n, lid, dtype=np.int64), permits,
                    deadline_ms=deadline_ms, trace_id=trace_id)
        except OverloadedError:
            if self.telemetry is not None:
                self.telemetry.note_shed(lid, n)
            raise

    def acquire_many(
        self, algo: str, lid_per_req: Sequence[int], keys: Sequence[str],
        permits: Sequence[int],
    ) -> Dict[str, np.ndarray]:
        """Whole-batch synchronous decision (the vectorized path)."""
        self._check_not_promoting()
        if self._fenced_shards:
            self._check_fence_keys(lid_per_req, keys)
        index = self._index[algo]
        lid0 = lid_per_req[0] if len(lid_per_req) else 0
        if (all(lid == lid0 for lid in lid_per_req)
                and hasattr(index, "assign_batch_strs")):
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
        return self._acquire_keyed(algo, lid_per_req, keys, permits)

    def _acquire_keyed(self, algo: str, lid_per_req, keys,
                       permits) -> Dict[str, np.ndarray]:
        """One synchronous batch assigned key by key (several limiters in
        a batch, or the keyed index)."""
        index = self._index[algo]
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
        (pinned until the batch is enqueued), one device batch decides.
        The keyed index assigns key by key instead, to the same
        decisions."""
        self._check_not_promoting()
        if self._fenced_shards:
            self._check_fence_int_keys(key_ids)
        index = self._index[algo]
        if not hasattr(index, "assign_batch_ints"):
            return self._acquire_keyed(algo, [int(lid)] * len(key_ids),
                                       [int(k) for k in key_ids], permits)
        self._batcher.flush()
        with self._evictions_cleared(algo):
            slots, clears = index.assign_batch_ints(
                np.ascontiguousarray(key_ids, dtype=np.int64), lid,
                pinned=self._batcher.pending_slots(algo), hold_pins=True)
        lids = np.full(len(slots), lid, dtype=np.int32)
        with self._pins_released(index, slots):
            return self._batcher.dispatch_direct(algo, slots, lids, permits,
                                                 list(clears))

    def acquire_stream_ids(self, algo: str, lid, key_ids: np.ndarray,
                           permits: np.ndarray | None = None, *,
                           batch: int = 1 << 14,
                           subbatches: int = 4) -> np.ndarray:
        """Whole-stream int-key decisions, pipelined; returns bool[n]
        allowed, in arrival order.

        Every request of a chunk is stamped with the chunk's time, and
        decisions equal ``acquire_many_ids`` on the same chunking.  Keys
        share the (lid, key) namespace of ``acquire_many_ids`` and
        ``acquire``, so the paths mix freely.  Pending micro-batch traffic
        is flushed first.

        ``lid`` is one limiter id for the whole stream, or an int array of
        per-request limiter ids (a ValueError names ids outside the
        table).  ``permits=None`` means one permit per request.  Permits
        below int32 raise ValueError; permits above 2^31-1 exceed every
        limiter's max_permits and are denied without touching state.

        Routes, as the reference's (``ratelimiter_tpu/storage/tpu.py``):
        - one limiter, every permit in [1, 255], none oversize: the
          weighted relay (:meth:`_stream_weighted`);
        - unit permits, one limiter or a lid array, every limit below the
          relay word's count clamp: the relay (:meth:`_stream_relay`),
          which elects per chunk the digest (one limiter), the resident
          digest (a lid array) or words mode (duplicate-poor chunks, and
          limits past uint16 counts), as the reference elects without a
          link profile;
        - everything else: the flat sorted step, in super-batches of
          ``batch * subbatches`` requests (:meth:`_stream_flat`).
        The reference's split digest is elected only under a link
        profile, which this storage does not take.  The keyed index
        (``checkpointable=True``) takes none of them: its stream goes in
        synchronous batches of ``batch`` requests (:meth:`_stream_keyed`)."""
        self._check_not_promoting()
        if self._fenced_shards:
            self._check_fence_int_keys(key_ids)
        multi_lid = np.ndim(lid) != 0
        lid_arr = None
        if multi_lid:
            lid_arr = np.ascontiguousarray(lid, dtype=np.int64)
            if lid_arr.size and ((lid_arr < 0)
                                 | (lid_arr >= len(self.table))).any():
                raise ValueError("limiter ids out of range")
        raw_permits = permits
        permits, oversize = self._stream_permits(permits)
        index = self._index[algo]
        if not hasattr(index, "assign_batch_ints"):
            lids = (lid_arr.tolist() if multi_lid
                    else [int(lid)] * len(key_ids))
            return self._stream_keyed(algo, lids,
                                      np.asarray(key_ids).tolist(),
                                      raw_permits, batch)
        self._batcher.flush()
        key_ids = np.ascontiguousarray(key_ids, dtype=np.int64)
        eng = self.engine
        rb = eng.rank_bits
        n = len(key_ids)
        if self._weighted_permits(permits, oversize) and not multi_lid:
            def walk_w(start, count, pinned):
                return index.assign_batch_ints_uniques(
                    key_ids[start:start + count], int(lid), rb,
                    pinned=pinned, hold_pins=True)
            return self._stream_weighted(
                algo, int(lid), n,
                np.ascontiguousarray(permits, dtype=np.int64), walk_w)
        if permits is None and eng.relay_usable():
            def walk_u(start, count, pinned):
                keys = key_ids[start:start + count]
                if lid_arr is None:
                    return index.assign_batch_ints_uniques(
                        keys, int(lid), rb, pinned=pinned, hold_pins=True)
                return index.assign_batch_ints_multi_uniques(
                    keys, lid_arr[start:start + count], rb, pinned=pinned,
                    hold_pins=True)
            return self._stream_relay(algo, None if multi_lid else int(lid),
                                      n, walk_u, lid_arr)

        def walk(start, count, pinned):
            keys = key_ids[start:start + count]
            if lid_arr is None:
                return index.assign_batch_ints(keys, lid, pinned=pinned,
                                               hold_pins=True)
            return index.assign_batch_ints_multi(
                keys, lid_arr[start:start + count], pinned=pinned,
                hold_pins=True)
        return self._stream_flat(algo, lid, n, walk, permits, oversize,
                                 batch, subbatches, lid_arr)

    def acquire_stream_strs(self, algo: str, lid: int, keys: Sequence[str],
                            permits: np.ndarray | None = None, *,
                            batch: int = 1 << 14,
                            subbatches: int = 4) -> np.ndarray:
        """Whole-stream string-key decisions of one limiter, pipelined;
        returns bool[n] allowed, in arrival order.

        The string counterpart of :meth:`acquire_stream_ids`, with its
        routes and their conditions: permits in [1, 255], none oversize,
        take the weighted relay; unit permits under limits below the relay
        word's count clamp the relay (digest or words per chunk); the
        rest the flat sorted step in super-batches of ``batch *
        subbatches`` requests.  Each chunk's keys are a window of ``keys``
        (a list, tuple or array of str), hashed once into the index's
        fingerprints (``native_index.hash_str_keys``); the hashing
        seconds go into each chunk record's ``pack_s``.  Keys share the (lid, key) namespace of
        :meth:`acquire_many` and :meth:`acquire`.  Decisions equal
        :meth:`acquire_many` on the same chunks.

        The keyed index (``checkpointable=True``) takes the reference's
        fallback: synchronous batches of ``batch`` requests
        (:meth:`_stream_keyed`).  The reference's sharded route does not
        arise here (the port has one device)."""
        self._check_not_promoting()
        if self._fenced_shards:
            self._check_fence_keys([lid] * len(keys), keys)
        raw_permits = permits
        permits, oversize = self._stream_permits(permits)
        index = self._index[algo]
        if not hasattr(index, "assign_batch_strs"):
            return self._stream_keyed(algo, [int(lid)] * len(keys),
                                      list(keys), raw_permits, batch)
        self._batcher.flush()
        eng = self.engine
        rb = eng.rank_bits
        lid = int(lid)
        n = len(keys)
        hashing = [0.0]  # the last walk's hashing seconds

        def fingerprints(start, count):
            t0 = time.perf_counter()
            fps = hash_str_keys(keys, lid, start, count)
            hashing[0] = time.perf_counter() - t0
            return fps

        def pack_s():
            return hashing[0]

        def walk_u(start, count, pinned):
            return index.assign_batch_fps_uniques(
                *fingerprints(start, count), rb, pinned=pinned,
                hold_pins=True)
        if self._weighted_permits(permits, oversize):
            return self._stream_weighted(
                algo, lid, n, np.ascontiguousarray(permits, dtype=np.int64),
                walk_u, pack_s=pack_s)
        if permits is None and eng.relay_usable():
            return self._stream_relay(algo, lid, n, walk_u, pack_s=pack_s)

        def walk(start, count, pinned):
            return index.assign_batch_fps(*fingerprints(start, count),
                                          pinned=pinned, hold_pins=True)
        return self._stream_flat(algo, lid, n, walk, permits, oversize,
                                 batch, subbatches, None, pack_s=pack_s)

    def _stream_keyed(self, algo: str, lids: list, keys: list, permits,
                      batch: int) -> np.ndarray:
        """A stream over the keyed index, as the reference's fallback runs
        it: synchronous batches of ``batch`` requests, each assigned key
        by key (:meth:`_acquire_keyed`); ``permits=None`` is one permit
        per request.  Returns bool[n] allowed."""
        n = len(keys)
        out = np.empty(n, dtype=bool)
        p = (np.ones(n, dtype=np.int64) if permits is None
             else np.asarray(permits))
        for i in range(0, n, batch):
            out[i:i + batch] = self._acquire_keyed(
                algo, lids[i:i + batch], keys[i:i + batch],
                p[i:i + batch])["allowed"]
        return out

    @staticmethod
    def _stream_permits(permits):
        """(permits, oversize) for a stream call.  The stream steps carry
        permits as int32 lanes; a value past 2^31-1 would wrap negative.
        max_permits always fits int32, so such a request is above every
        limiter's cap: ``oversize`` marks it (None when there is none),
        its permits become 1, and its lane goes as padding (slot -1), the
        micro route's reject, state untouched.  Permits below int32 raise
        ValueError."""
        if permits is None:
            return None, None
        permits = np.asarray(permits)
        if permits.size and int(permits.min(initial=0)) < np.iinfo(
                np.int32).min:
            raise ValueError("permits below int32 range")
        over = permits > np.iinfo(np.int32).max
        if not over.any():
            return permits, None
        return np.where(over, 1, permits), over

    def _weighted_permits(self, permits, oversize) -> bool:
        """Whether a permits lane takes the weighted relay: every permit in
        [1, ``weighted_permit_cap``], none oversize."""
        return bool(permits is not None and oversize is None and permits.size
                    and int(permits.min()) >= 1
                    and int(permits.max()) <= self.engine.weighted_permit_cap)

    def _run_chunks(self, algo: str, n: int, first: int, assign,
                    dispatch, pack_s=None) -> np.ndarray:
        """The stream loops' one pipeline, one deep in one thread: chunk k
        is dispatched, chunk k+1 is assigned while the card runs chunk k
        (the C walk releases the GIL), then chunk k is drained.

        ``assign(start, count)`` runs the C index with the chunk's slots
        pinned and returns (the pinned slots, the evictions, a payload).
        Under the pins the evictions are cleared and
        ``dispatch(start, count, payload, rec)`` enqueues the chunk and
        returns (a drain giving its decisions, the next chunk's size); the
        pins are released once the chunk is enqueued.  Each chunk's record
        ``rec`` (its mode, sizes and host timings in seconds; for string
        keys ``pack_s``, which the caller's ``pack_s()`` gives as the last
        assign's hashing share of ``assign_s``; under a partitioned index
        its partition count as ``host_parallel``) goes into
        ``last_stream_chunks``; each assign's seconds go into the
        ``index`` stage timer (the drains record ``fetch`` and the
        dispatch, :meth:`_fetch`).  Returns bool[n] allowed."""
        index = self._index[algo]
        out = np.empty(n, dtype=bool)
        chunks: List[dict] = []
        self.last_stream_chunks = chunks

        def timed_assign(start: int, count: int):
            t0 = time.perf_counter()
            res = assign(start, count)
            assign_s = time.perf_counter() - t0
            self._stage("index", assign_s)
            return (start, count, *res, assign_s,
                    None if pack_s is None else pack_s())

        nxt = timed_assign(0, min(first, n)) if n else None
        try:
            while nxt is not None:
                start, count, pins, clears, payload, assign_s, hash_s = nxt
                nxt = None
                rec = {"requests": count, "assign_s": assign_s}
                if self._host_parallel:
                    rec["host_parallel"] = self._host_parallel
                if hash_s is not None:
                    rec["pack_s"] = hash_s
                chunks.append(rec)
                with self._pins_released(index, pins):
                    if len(clears):
                        self._clear_slots(algo, list(clears))
                    drain, size = dispatch(start, count, payload, rec)
                if start + count < n:
                    nxt = timed_assign(start + count,
                                       min(size, n - start - count))
                t0 = time.perf_counter()
                out[start:start + count] = drain()
                rec["drain_s"] = time.perf_counter() - t0
        finally:
            if nxt is not None:
                # An assignment the loop never dispatched: its evictions
                # are applied in the index and its slots pinned.
                try:
                    if len(nxt[3]):
                        self._clear_slots(algo, list(nxt[3]))
                finally:
                    index.unpin_batch(nxt[2])
        return out

    def _assign_uniques(self, algo: str, walk):
        """The relays' assign for :meth:`_run_chunks`: ``walk(start, count,
        pinned)`` runs the C index's unique-compacting assign over the
        chunk with the unique slots pinned (one word per unique slot, slot
        | clamped count; each request's unique index and rank; the
        evictions); evictions of a failed walk are cleared."""
        rb = self.engine.rank_bits

        def assign(start: int, count: int):
            with self._evictions_cleared(algo):
                uwords, uidx, rank, clears = walk(
                    start, count, self._batcher.pending_slots(algo))
            uslots = (uwords >> np.uint32(rb + 1)).astype(np.int32)
            return uslots, clears, (uwords, uidx, rank, uslots)
        return assign

    def _stream_relay(self, algo: str, lid: int | None, n: int, walk,
                      lid_arr: np.ndarray | None = None,
                      pack_s=None) -> np.ndarray:
        """The relay loop (:meth:`_run_chunks`) over ``n`` requests with
        unit permits of one limiter ``lid`` or of the per-request
        ``lid_arr``, assigned by ``walk`` (:meth:`_assign_uniques`).  Each
        chunk takes one of three modes, elected as the reference elects
        them without a link profile (:func:`_elect_digest`):

        - ``relay``, the digest of one limiter: the uniques, sorted by
          slot when there are many, go up as words padded to a power of
          two with 0xFFFFFFFF; the per-unique allowed counts come back and
          the host rebuilds each request's decision as ``rank <
          counts[uidx]``;
        - ``resident``, the digest of a lid array: as ``relay``, with the
          (slot, lid) pairs the engine's lid map does not hold yet
          uploaded beside the words (padded with slot -1 to a power of
          two, at least ``_DELTA_FLOOR``), and marked held once the step
          is enqueued;
        - ``words``: one word per request (slot | clamped rank | last,
          ``native_index.rebuild_words_into``) with the limiter id or a
          lid lane, packed allow bits back.  It takes duplicate-poor
          chunks, and every chunk when the counts fit no dtype.

        Chunks grow toward their mode's wire budget at the bytes per
        request the chunk shipped.  Each chunk's record: its mode,
        uniques, the lid pairs uploaded (``deltas``, padded to
        ``delta_lanes``), and the layout (``sort_s`` of it the slot
        sort), enqueue and drain times."""
        eng = self.engine
        rb = eng.rank_bits
        cdt = eng.counts_dtype()
        multi = lid_arr is not None
        digest_bpu, words_bpr = wire_costs(multi)
        sw = algo == "sw"
        counts_dispatch = (eng.sw_relay_counts_dispatch if sw
                           else eng.tb_relay_counts_dispatch)
        resident_dispatch = (eng.sw_relay_counts_resident_dispatch if sw
                             else eng.tb_relay_counts_resident_dispatch)
        bits_dispatch = eng.sw_relay_dispatch if sw else eng.tb_relay_dispatch
        lock = self._lid_locks[algo]
        known = None
        if multi and cdt is not None:
            with lock:
                known = self._lid_known.setdefault(
                    algo, np.zeros(eng.num_slots, dtype=bool))

        def dispatch(start, count, payload, rec):
            uwords, uidx, rank, uslots = payload
            u = len(uwords)
            t0 = time.perf_counter()
            n_delta = 0
            if known is not None:
                with lock:
                    fresh = ~known[uslots]
                n_delta = max(_pow2(int(fresh.sum())), _DELTA_FLOOR)
            rec.update(uniques=u, deltas=0, delta_lanes=0, sort_s=0.0)
            now = self._monotonic_now()
            if cdt is not None and _elect_digest(u, count, n_delta,
                                                 digest_bpu, words_bpr):
                if u >= _SORT_UNIQUES_MIN:
                    sort_uniques(uwords, rb, uidx)
                    rec["sort_s"] = time.perf_counter() - t0
                # A fresh buffer per chunk: the upload may alias it until
                # the chunk is drained.
                words = np.full(_pow2(u), 0xFFFFFFFF, dtype=np.uint32)
                words[:u] = uwords
                if multi:
                    rec["mode"] = "resident"
                    # Each unique's lid, by unique index (rank 0 is the
                    # unique's first request).
                    firsts = rank == 0
                    ulids = np.zeros(u, dtype=np.int32)
                    ulids[uidx[firsts]] = lid_arr[start:start + count][firsts]
                    # The sort reordered the words in place.
                    us = (uwords >> np.uint32(rb + 1)).astype(np.int64)
                    with lock:
                        fresh = ~known[us]
                        nd = int(fresh.sum())
                        n_delta = max(_pow2(nd), _DELTA_FLOOR)
                        d_slots = np.full(n_delta, -1, dtype=np.int32)
                        d_slots[:nd] = us[fresh]
                        d_lids = np.zeros(n_delta, dtype=np.int32)
                        d_lids[:nd] = ulids[fresh]
                        t1 = time.perf_counter()
                        counts = resident_dispatch(words, d_slots, d_lids,
                                                   now, cdt)
                        # Marked after the dispatch: a raise leaves the
                        # pairs to upload again.
                        known[us[fresh]] = True
                    rec.update(deltas=nd, delta_lanes=n_delta)
                else:
                    rec["mode"] = "relay"
                    t1 = time.perf_counter()
                    counts = counts_dispatch(words, lid, now, cdt)

                def drain():
                    return self._fetch(
                        algo, "relay|digest", t0, counts[:u],
                        lambda arr: relay_decide(arr, uidx, rank), lid)
                wire = digest_bpu * u + 8 * n_delta
                budget = _RELAY_WIRE_BUDGET_DIGEST
            else:
                rec["mode"] = "words"
                size = _pow2(count)
                words = np.full(size, 0xFFFFFFFF, dtype=np.uint32)
                rebuild_words_into(uwords, uidx, rank, rb, words[:count])
                lids = lid
                if multi:
                    lids = np.zeros(size, dtype=np.int32)
                    lids[:count] = lid_arr[start:start + count]
                t1 = time.perf_counter()
                bits = bits_dispatch(words, lids, now)

                def drain():
                    return self._fetch(
                        algo, "relay|bits", t0, bits,
                        lambda arr: np.unpackbits(arr)[:count].astype(bool),
                        lid)
                wire = words_bpr * count
                budget = _RELAY_WIRE_BUDGET_WORDS
            rec["layout_s"] = t1 - t0
            rec["enqueue_s"] = time.perf_counter() - t1
            self._stage("layout", rec["layout_s"])
            self._stage("enqueue", rec["enqueue_s"])
            if "pack_s" in rec and not self._host_parallel:
                # The reference reads the hashing time off its single C
                # index; its partitioned index reports none.
                self._stage("pack", rec["pack_s"])
            bpr = max(wire / count, 1e-3)
            return drain, int(min(max(budget / bpr, _RELAY_CHUNK),
                                  _RELAY_CHUNK_MAX))

        return self._run_chunks(algo, n, _RELAY_CHUNK,
                                self._assign_uniques(algo, walk), dispatch,
                                pack_s)

    def _stream_weighted(self, algo: str, lid: int, n: int,
                         permits: np.ndarray, walk,
                         pack_s=None) -> np.ndarray:
        """The weighted relay loop (:meth:`_run_chunks`) over ``n``
        requests of one limiter with permits in [1, 255], assigned by
        ``walk`` (:meth:`_assign_uniques`).  Per chunk the C index's
        duplicate structure picks one of three modes:

        - ``weighted_coal``: every repeat of a key in the chunk carries the
          same permits, so one lane per unique computes its allowed count
          and the host rebuilds ``rank < counts[uidx]``;
        - ``weighted``: the deepest key repeats at most ``_WREL_MAX_R``
          times, so the segments go to the card sorted by count,
          descending, with their permits rank-major
          (``native_index.weighted_layout``), a scan over the rank steps
          decides them, and ``native_index.weighted_decide`` reads each
          request's bit;
        - ``flat_fb``: deeper chunks run the flat sorted step over at most
          ``_FLAT_MAX_LANES`` requests a dispatch.

        Chunks grow toward ``_RELAY_WIRE_BUDGET_WEIGHTED`` at the wire
        bytes per request the last chunk's mode took.  Each chunk's
        record: its mode, uniques, and the layout, enqueue and drain
        times."""
        eng = self.engine
        rb = eng.rank_bits
        cdt = eng.counts_dtype()
        sw = algo == "sw"
        coal_dispatch = (eng.sw_weighted_counts_dispatch if sw
                         else eng.tb_weighted_counts_dispatch)
        rank_dispatch = (eng.sw_weighted_dispatch if sw
                         else eng.tb_weighted_dispatch)
        flat_dispatch = eng.sw_flat_dispatch if sw else eng.tb_flat_dispatch
        # The rank-major layout needs true counts: the word's count field
        # clamps at 2^rank_bits - 1.
        r_cap = min(_WREL_MAX_R, (1 << rb) - 1)

        def dispatch(start, count, payload, rec):
            uwords, uidx, rank, uslots = payload
            p_chunk = permits[start:start + count]
            t0 = time.perf_counter()
            u = len(uwords)
            rec["uniques"] = u
            r_max = int(rank.max()) + 1
            wlane = None
            # Coalescible when every request carries the permits of its
            # key's first request, and the words' clamped counts decide
            # exactly: every limit lies below the clamp (relay_usable), or
            # no count reaches it.  The reference checks only the first
            # two; past the clamp its counts cut a deep key's allowed
            # prefix short (ROADMAP C3).
            if cdt is not None and (eng.relay_usable()
                                    or r_max < (1 << rb) - 1):
                wlane = np.zeros(u, dtype=np.uint8)
                firsts = rank == 0
                wlane[uidx[firsts]] = p_chunk[firsts]
                if np.any(wlane[uidx] != p_chunk):
                    wlane = None
            if wlane is not None:
                rec["mode"] = "weighted_coal"
                t1 = time.perf_counter()
                counts = coal_dispatch(uwords, wlane, lid,
                                       self._monotonic_now(), cdt)

                def drain():
                    return self._fetch(
                        algo, "relay_w|weighted_coal", t0, counts,
                        lambda arr: relay_decide(arr, uidx, rank), lid)
                wire = (5 + np.dtype(cdt).itemsize) * u
            elif r_max <= r_cap:
                rec["mode"] = "weighted"
                r_b = 2
                while r_b < r_max:
                    r_b *= 2
                u_b = _bucket_fine(u)
                uw_sorted = np.full(u_b, 0xFFFFFFFF, dtype=np.uint32)
                spos = np.empty(u, dtype=np.int32)
                roff = np.empty(r_b, dtype=np.int64)
                perms_rank = np.zeros(_bucket_fine(count) + u_b,
                                      dtype=np.uint8)
                weighted_layout(uwords, rb, uidx, rank, p_chunk, r_b,
                                uw_sorted, spos, roff, perms_rank)
                t1 = time.perf_counter()
                bits = rank_dispatch(uw_sorted, perms_rank, roff, lid,
                                     self._monotonic_now(), r_b)

                def drain():
                    return self._fetch(
                        algo, "relay_w|weighted_native", t0, bits,
                        lambda arr: weighted_decide(arr, roff, spos, uidx,
                                                    rank), lid)
                wire = 4 * u_b + len(perms_rank) + len(perms_rank) // 8
            else:
                rec["mode"] = "flat_fb"
                slots_req = uslots[uidx]
                p8 = p_chunk.astype(np.uint8)
                t1 = time.perf_counter()
                now = self._monotonic_now()
                parts = [flat_dispatch(slots_req[o:o + _FLAT_MAX_LANES], lid,
                                       p8[o:o + _FLAT_MAX_LANES], now)
                         for o in range(0, count, _FLAT_MAX_LANES)]

                def drain():
                    # One fetch and record per flat dispatch, as the
                    # reference's drains.
                    return np.concatenate([
                        self._fetch(algo, "relay_w|flat", t0, b,
                                    lambda arr, m=min(_FLAT_MAX_LANES,
                                                      count - o):
                                    np.unpackbits(arr)[:m].astype(bool),
                                    lid)
                        for o, b in zip(range(0, count, _FLAT_MAX_LANES),
                                        parts)])
                wire = 5 * count
            rec["layout_s"] = t1 - t0
            rec["enqueue_s"] = time.perf_counter() - t1
            return drain, int(min(max(_RELAY_WIRE_BUDGET_WEIGHTED * count
                                      / wire, _RELAY_CHUNK),
                                  _RELAY_CHUNK_MAX))

        return self._run_chunks(algo, n, _RELAY_CHUNK,
                                self._assign_uniques(algo, walk), dispatch,
                                pack_s)

    def _stream_flat(self, algo: str, lid, n: int, walk,
                     permits: np.ndarray | None,
                     oversize: np.ndarray | None, batch: int,
                     subbatches: int, lid_arr: np.ndarray | None,
                     pack_s=None) -> np.ndarray:
        """The flat stream loop (:meth:`_run_chunks`) over ``n`` requests:
        per super-batch of ``batch * subbatches`` requests one C call
        (``walk(start, count, pinned)``, the slots pinned) assigns the
        slots (one limiter, or one per request from ``lid_arr``), one flat
        sorted step decides them all at the super-batch's timestamp, and
        its packed bits come back.

        A super-batch past ``_FLAT_MAX_LANES`` runs as a K-step scan of
        steps of that many lanes (the tail padded with -1 slots) instead,
        K bounded by the stream's length, so the kernels never see more
        than the cap.  Oversize permits go as -1 slots (denied, state
        untouched).  Permits ship as uint8 when every one lies in
        [0, 255], else as int32.  Each chunk's record: its mode (``flat``
        or ``scan``), and the layout, enqueue and drain times."""
        eng = self.engine
        super_n = int(subbatches) * int(batch)
        k_scan = 0
        if super_n > _FLAT_MAX_LANES:
            k_scan = min(-(-super_n // _FLAT_MAX_LANES),
                         max(-(-n // _FLAT_MAX_LANES), 1))
            super_n = k_scan * _FLAT_MAX_LANES
            if k_scan == 1:
                k_scan = 0  # one flat step at the cap
        sw = algo == "sw"
        flat_dispatch = eng.sw_flat_dispatch if sw else eng.tb_flat_dispatch
        scan_dispatch = eng.sw_scan_dispatch if sw else eng.tb_scan_dispatch
        p_dtype = np.int32
        if (permits is not None and permits.size
                and int(permits.min()) >= 0 and int(permits.max()) <= 255):
            p_dtype = np.uint8
        # The reference names the route by the stream's K, not the
        # chunk's.
        path = "flat|scan" if k_scan else "flat|sorted"

        def assign(start: int, count: int):
            with self._evictions_cleared(algo):
                slots, clears = walk(start, count,
                                     self._batcher.pending_slots(algo))
            return slots, clears, slots

        def lanes(values, size, fill, dtype):
            arr = np.full(size, fill, dtype=dtype)
            arr[:len(values)] = values
            return arr

        def dispatch(start, count, slots, rec):
            # A tail super-batch scans only the steps it fills.
            k_i = min(k_scan, -(-count // _FLAT_MAX_LANES))
            size = k_i * _FLAT_MAX_LANES if k_i else count
            rec["mode"] = "scan" if k_i else "flat"
            t0 = time.perf_counter()
            s_lane = lanes(slots, size, -1, np.int32)
            if oversize is not None:
                s_lane[:count][oversize[start:start + count]] = -1
            l_lane = lid if lid_arr is None else lanes(
                lid_arr[start:start + count], size, 0, np.int32)
            p_lane = None if permits is None else lanes(
                permits[start:start + count], size, 1, p_dtype)
            t1 = time.perf_counter()
            now = self._monotonic_now()
            if k_i:
                shape = (k_i, _FLAT_MAX_LANES)
                bits = scan_dispatch(
                    s_lane.reshape(shape),
                    l_lane if lid_arr is None else l_lane.reshape(shape),
                    None if p_lane is None else p_lane.reshape(shape),
                    np.full(k_i, now, dtype=np.int64))
            else:
                bits = flat_dispatch(s_lane, l_lane, p_lane, now)
            rec["layout_s"] = t1 - t0
            rec["enqueue_s"] = time.perf_counter() - t1
            self._stage("enqueue", rec["enqueue_s"])
            return (lambda: self._fetch(
                algo, path, t0, bits,
                lambda arr: np.unpackbits(arr, axis=-1).reshape(-1)[:count]
                .astype(bool), lid if lid_arr is None else None)), super_n

        return self._run_chunks(algo, n, super_n, assign, dispatch, pack_s)

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
        assigned the slot before it is clean.  The hybrid tier forgets
        the key first, so a concurrent serve cannot answer from
        pre-reset counters."""
        index = self._index[algo]
        if self._serving is not None:
            self._serving.invalidate(algo, lid, key)
        if index.get((lid, key)) is None:
            return
        self._batcher.flush()
        slot = index.get((lid, key))
        if slot is None:
            return
        self._clear_slots(algo, [slot])
        index.remove((lid, key))

    # ------------------------------------------------------------------------
    # Token leases (leases/): atomic reserve / credit for one key
    # ------------------------------------------------------------------------
    def lease_reserve(self, algo: str, lid: int, key: str,
                      requested: int) -> Dict:
        """Charge up to ``requested`` permits for one key against the live
        device counters: the grant side of a token lease
        (``leases/manager.py``).  Pending micro-batch traffic is flushed
        first, so the grant observes every decision already admitted.
        Returns ``{"granted", "ws", "stamp"}``: ``ws`` is the charged
        window start (sliding window; 0 for the token bucket), which
        :meth:`lease_credit` must present.

        A slot the assignment evicts is cleared on the spot, in stream
        order ahead of the reserve.  The reference queues that clear in
        the batcher after its flush (``storage/tpu.py:3181-3182``), so its
        reserve can read the evicted key's row and the late clear then
        wipes the charge just made (ROADMAP C8).

        The fence and promotion checks of every decision surface guard
        it: a fenced storage refuses with ``FencedError``, which the
        lease manager turns into a revocation."""
        self._check_not_promoting()
        if self._fenced_shards:
            self._check_fence_keys([lid], [key])
        if self._serving is not None:
            # A leased key's state changes outside the hybrid tier's
            # watch: its adopted snapshot is stale once the reserve lands.
            self._serving.invalidate(algo, lid, key)
        self._batcher.flush()
        index = self._index[algo]
        slot, evicted = index.assign(
            (lid, key), pinned=self._batcher.pending_slots(algo),
            hold_pin=True)
        with self._pins_released(index, [slot]):
            if evicted is not None:
                self._clear_slots(algo, [evicted])
            now = self._monotonic_now()
            granted, ws = self.engine.lease_reserve(
                algo, [slot], [int(lid)], [int(requested)], now)
        return {"granted": int(granted[0]), "ws": int(ws[0]),
                "stamp": int(now)}

    def lease_credit(self, algo: str, lid: int, key: str, credit: int,
                     grant_ws: int) -> Dict:
        """Return ``credit`` unused reserved permits for one key (lease
        renewal or release).  A key whose slot was evicted credits
        nothing: its charge was cleared with the slot.  Returns
        ``{"credited", "stamp"}`` (the stamp makes the operation
        replayable against the oracle).  Guarded as :meth:`lease_reserve`."""
        self._check_not_promoting()
        if self._fenced_shards:
            self._check_fence_keys([lid], [key])
        index = self._index[algo]
        if index.get((lid, key)) is None:
            return {"credited": 0, "stamp": 0}
        if self._serving is not None:
            self._serving.invalidate(algo, lid, key)
        self._batcher.flush()
        slot = index.get((lid, key))
        if slot is None:
            return {"credited": 0, "stamp": 0}
        now = self._monotonic_now()
        credited = self.engine.lease_credit(
            algo, [slot], [int(lid)], [int(credit)], [int(grant_ws)], now)
        return {"credited": int(credited[0]), "stamp": int(now)}

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
        for index in self._index.values():
            if isinstance(index, PartitionedSlotIndex):
                index.close()

    # ------------------------------------------------------------------------
    # Checkpoint / resume and per-key export / import (engine/checkpoint.py)
    # ------------------------------------------------------------------------
    def save_checkpoint(self, path: str) -> None:
        """Flush pending work and snapshot the card's state and the
        key->slot maps into the directory ``path`` (atomic)."""
        self._batcher.flush()
        self.engine.block_until_ready()
        ckpt.save_checkpoint(path, self.engine, ckpt.dump_slot_indexes(self))

    def restore_checkpoint(self, path: str) -> None:
        """Load a checkpoint of this geometry (either package's): the state
        rows are copied into the resident tensors in place, the key->slot
        maps rebuilt with their LRU order, and the hybrid tier forgets
        what it adopted."""
        data = ckpt.load_checkpoint(path)
        self._batcher.flush()
        self._forget_adopted()
        ckpt.restore_engine_state(self.engine, data)
        ckpt.restore_slot_indexes(self, data["meta"]["index"])
        # The lid map is not checkpointed: forget what the card holds, so
        # the next resident digest uploads the lids again.
        self._lid_known.clear()

    def export_keys(self) -> Dict:
        """Geometry-free export of every live key's state
        (``engine/checkpoint.py:export_keys``, which flushes first)."""
        return ckpt.export_keys(self)

    def import_keys(self, dump: Dict) -> None:
        """Import an export into this storage's geometry: its own index
        assigns the slots (this is the rebalance), the rows go in through
        ``engine.write_rows``, and the hybrid tier forgets what it
        adopted."""
        self._batcher.flush()
        self._forget_adopted()
        ckpt.import_keys(self, dump)
        self._lid_known.clear()  # imported slots carry unknown lids

    def _forget_adopted(self) -> None:
        """The hybrid tier forgets every adopted state: a restore, an
        import or a promotion rewrites rows or slots under its keys.  The
        reference's restore and import keep the tier's state, and its
        next serves answer from the rows before the rewrite (ROADMAP
        C9)."""
        if self._serving is not None:
            self._serving.invalidate_all()

    def promote_from_replica(self, index_dump: Dict) -> None:
        """Standby promotion: the engine already holds the replicated rows
        and the index is rebuilt from ``index_dump`` (a
        ``dump_slot_indexes`` payload).  Decisions racing the rebuild are
        refused with the retryable ``PromotionInProgressError``; the
        hybrid tier forgets every adopted state and the lid map is
        uploaded again."""
        self._promoting = True
        try:
            self._batcher.flush()
            self._forget_adopted()
            ckpt.restore_slot_indexes(self, index_dump)
            self._lid_known.clear()
            self.engine.block_until_ready()
        finally:
            self._promoting = False

    # ------------------------------------------------------------------------
    # Fencing and the serving lease
    # ------------------------------------------------------------------------
    def fence(self, epoch: int, shards=None) -> int:
        """Install a fence at a monotonic ``epoch``: this storage (or the
        named ``shards`` of a sharded engine) refuses every further
        decision with ``FencedError``, so a replaced primary that still
        runs cannot admit traffic beside its replacement.  An epoch at or
        below the installed one raises ValueError and changes nothing."""
        epoch = int(epoch)
        if epoch <= self._fence_epoch:
            raise ValueError(
                f"fence epoch {epoch} is not past the installed epoch "
                f"{self._fence_epoch}; fencing is monotonic")
        self._fence_epoch = epoch
        if shards is None:
            self._fence_all = True
            self._full_fence_epoch = epoch
            # An explicit fence supersedes the serving lease.
            self._lease_deadline_ms = 0
        else:
            self._fenced_shards = self._fenced_shards | frozenset(
                int(q) for q in shards)
            for q in shards:
                self._shard_fence_epochs[int(q)] = epoch
        if self._recorder is not None:
            self._recorder.record(
                "fence.installed", epoch=epoch,
                shards=(sorted(self._fenced_shards) if shards is not None
                        else "all"))
        return epoch

    def lift_fence(self, epoch: int, shards=None) -> None:
        """Lift the fence (the operator's action).  ``epoch`` must be at or
        past the installed one; a stale lift raises ValueError.  A whole
        lift also clears a serving-lease self-fence."""
        if int(epoch) < self._fence_epoch:
            raise ValueError(
                f"lift epoch {epoch} is behind the installed fence epoch "
                f"{self._fence_epoch}")
        if shards is None:
            self._fence_all = False
            self._fenced_shards = frozenset()
            self.lease_self_fenced = False
        else:
            self._fenced_shards = self._fenced_shards - frozenset(
                int(q) for q in shards)
        if self._recorder is not None:
            self._recorder.record("fence.lifted", epoch=int(epoch))

    def fence_info(self) -> Dict:
        """The fence state.  Its epoch stamps token leases
        (``leases/manager.py``) and covers the serving lease's epoch, so a
        lease granted under one generation is revoked once a replacement
        carries the next."""
        return {"epoch": max(self._fence_epoch, self._lease_epoch),
                "all": self._fence_all,
                "shards": sorted(self._fenced_shards),
                "shard_epochs": dict(self._shard_fence_epochs),
                "rejected": self.fence_rejected}

    def lease_scope_epoch(self, lid: int, key) -> int:
        """The revocation epoch of a token lease on ``(lid, key)``: on one
        engine, every key's is the :meth:`fence_info` epoch."""
        n_sh = getattr(self.engine, "n_shards", None)
        if n_sh is None:
            return max(self._fence_epoch, self._lease_epoch)
        base = max(self._full_fence_epoch, self._lease_epoch)
        q = shard_of_key((int(lid), key), int(n_sh))
        return max(base, self._shard_fence_epochs.get(int(q), 0))

    def grant_serving_lease(self, epoch: int, ttl_ms: float) -> Dict:
        """Install or renew the serving lease: this storage may decide
        until ``ttl_ms`` from now on its own clock.  A grant never
        regresses the epoch and never resurrects a fenced storage (only
        :meth:`lift_fence` re-arms one); either raises ValueError."""
        epoch = int(epoch)
        if self._fence_all:
            raise ValueError(
                "storage is fenced; a serving lease cannot resurrect it "
                "(operator lift_fence first)")
        if epoch < self._lease_epoch:
            raise ValueError(
                f"serving-lease epoch {epoch} is behind the installed "
                f"epoch {self._lease_epoch}; grants are monotonic")
        self._lease_epoch = epoch
        self._lease_deadline_ms = int(self._clock_ms()) + int(ttl_ms)
        return self.serving_lease_info()

    def release_serving_lease(self) -> Dict:
        """Drop the serving lease on purpose (a graceful stop): not a
        fence, so a later grant at the same or a newer epoch re-arms
        serving without a lift."""
        self._lease_deadline_ms = 0
        if self._recorder is not None:
            self._recorder.record("lease.released",
                                  epoch=self._lease_epoch)
        return self.serving_lease_info()

    def serving_lease_info(self) -> Dict:
        now = int(self._clock_ms())
        installed = bool(self._lease_deadline_ms)
        return {
            "epoch": self._lease_epoch,
            "installed": installed,
            "ttl_remaining_ms": (max(self._lease_deadline_ms - now, 0)
                                 if installed else 0),
            "expired": bool(installed and now >= self._lease_deadline_ms),
            "self_fenced": self.lease_self_fenced,
        }

    def _lease_expired_fence(self) -> None:
        """The serving lease ran out: self-fence and refuse.  A
        replacement may own the keyspace now; what was admitted before
        this point is at most one lease TTL of traffic."""
        self._fence_all = True
        self._fence_epoch = max(self._fence_epoch, self._lease_epoch)
        self._full_fence_epoch = max(self._full_fence_epoch,
                                     self._fence_epoch)
        self._lease_deadline_ms = 0
        self.lease_self_fenced = True
        if self._recorder is not None:
            self._recorder.record("fence.lease_expired",
                                  epoch=self._lease_epoch)
        self._fence_reject("serving lease expired; orchestrator "
                           "unreachable — a replacement may own this "
                           "keyspace")

    def _fence_reject(self, detail: str):
        self.fence_rejected += 1
        raise FencedError(
            f"storage fenced at epoch {self._fence_epoch} ({detail}): a "
            "failover replacement owns this keyspace; this instance must "
            "not decide")

    def _check_fence_int_keys(self, key_ids) -> None:
        """Shard-scoped fence check for int-key batches (reached only
        while a shard fence is installed; one engine has no shards)."""
        n_sh = getattr(self.engine, "n_shards", None)
        if n_sh is None:
            return
        shards = shard_of_int_keys(
            np.ascontiguousarray(key_ids, dtype=np.int64), int(n_sh))
        hit = sorted(q for q in self._fenced_shards if (shards == q).any())
        if hit:
            self._fence_reject(f"request routes to fenced shard(s) {hit}")

    def _check_fence_keys(self, lid_per_req, keys) -> None:
        """Shard-scoped fence check for string-key batches (as
        :meth:`_check_fence_int_keys`)."""
        n_sh = getattr(self.engine, "n_shards", None)
        if n_sh is None:
            return
        for lid, key in zip(lid_per_req, keys):
            q = shard_of_key((int(lid), key), int(n_sh))
            if q in self._fenced_shards:
                self._fence_reject(f"key routes to fenced shard {q}")

    # ------------------------------------------------------------------------
    # Legacy 10-method contract (host-side, embedded InMemoryStorage)
    # ------------------------------------------------------------------------
    def increment_and_expire(self, key: str, ttl_ms: int) -> int:
        return self._host.increment_and_expire(key, ttl_ms)

    def get(self, key: str) -> int:
        return self._host.get(key)

    def set(self, key: str, value: int, ttl_ms: int) -> None:
        self._host.set(key, value, ttl_ms)

    def compare_and_set(self, key: str, expect: int, update: int) -> bool:
        return self._host.compare_and_set(key, expect, update)

    def delete(self, key: str) -> None:
        self._host.delete(key)

    def z_add(self, key: str, score: float, member: str) -> None:
        self._host.z_add(key, score, member)

    def z_remove_range_by_score(self, key: str, min_score: float,
                                max_score: float) -> int:
        return self._host.z_remove_range_by_score(key, min_score, max_score)

    def z_count(self, key: str, min_score: float, max_score: float) -> int:
        return self._host.z_count(key, min_score, max_score)

    def eval_script(self, script: str, keys: List[str], args: List[int]):
        return self._host.eval_script(script, keys, args)

    # ------------------------------------------------------------------------
    # Meters
    # ------------------------------------------------------------------------
    def _record_dispatch(self, algo: str, n: int, allowed: int,
                         dt_us: float, path: str = "micro",
                         lid=None) -> None:
        """Latency timer, decision trace and the flight recorder's
        slow-dispatch anomaly for one drained dispatch; ``path`` names
        its route (micro, relay|digest, relay|bits, relay_w|...,
        flat|sorted, flat|scan).  ``lid`` (a one-tenant dispatch's
        limiter id) feeds the telemetry plane's per-tenant usage; mixed
        micro batches feed it from their drainer instead.  With lineage
        sampling armed, a stream chunk mints a trace id; a sampled one
        records its hop and tags the trace record."""
        if not self._obs:
            return
        self._latency.record_us(dt_us)
        if lid is not None and self.telemetry is not None:
            self.telemetry.note_server(int(lid), n, allowed)
        extra = {}
        lin = self.lineage
        if lin is not None and lin.sample_n > 0 and path != "micro":
            from ratelimiter_tpu_torch.observability.telemetry import (
                mint_trace_id,
                trace_hex,
            )

            tid = mint_trace_id()
            if lin.sampled(tid):
                lin.record(tid, "shard", path=path, shard=0, algo=algo,
                           batch=n, device_us=round(dt_us, 1))
                extra["trace"] = trace_hex(tid)
        self.trace.record(algo, n, allowed, dt_us, path=path, **extra)
        rec = self._recorder
        if rec.slo_us > 0.0 and dt_us > rec.slo_us:
            rec.anomaly("slow_dispatch", dt_us, algo=algo, batch=n,
                        path=path)

    def _stage(self, stage: str, secs: float) -> None:
        """Record one chunk's seconds in a stream stage timer (no-op with
        observability off)."""
        t = self._stage_timers
        if t is not None:
            t[stage].record_us(secs * 1e6)

    def _fetch(self, algo: str, path: str, t0: float, handle,
               decode, lid=None) -> np.ndarray:
        """A stream chunk's (or slice's) one blocking fetch: ``decode``
        turns the host copy of ``handle`` into its decisions.  Records the
        fetch stage and the dispatch (``t0``: the chunk's start; ``lid``:
        the chunk's one limiter, None for a lid array)."""
        tf0 = time.perf_counter()
        arr = handle.cpu().numpy()
        tf1 = time.perf_counter()
        self._stage("fetch", tf1 - tf0)
        got = decode(arr)
        self._record_dispatch(algo, len(got), int(got.sum()),
                              (tf1 - t0) * 1e6, path=path, lid=lid)
        return got

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
        """Single choke point for zeroing evicted/reset slots.  A cleared
        slot may be reassigned to another (lid, key), so it is marked
        unknown to the resident digest's lid map, under the lock that
        digest holds from reading the marks to setting them: the clear
        wins, and the slot's lid is uploaded again at its next use."""
        if not len(slots):
            return
        if self._serving is not None:
            # A cleared slot's key state is gone on the card: any tier
            # entry tracking it is stale (evictions on the micro route
            # also invalidate at remap time, in _assign_slot; this is the
            # stream and direct paths' backstop).
            self._serving.invalidate_slots(algo, slots)
        with self._lid_locks[algo]:
            (self.engine.sw_clear if algo == "sw"
             else self.engine.tb_clear)(list(slots))
            known = self._lid_known.get(algo)
            if known is not None:
                known[np.asarray(slots, dtype=np.int64)] = False

    def _check_not_promoting(self) -> None:
        """Refuse decisions while a standby promotion swaps the key->slot
        indexes, and for good once this storage is whole-fenced.  With a
        serving lease installed, the first decision past its deadline
        self-fences here: every decision surface calls this first."""
        if self._fence_all:
            self._fence_reject("whole-storage fence")
        if self._lease_deadline_ms \
                and int(self._clock_ms()) >= self._lease_deadline_ms:
            self._lease_expired_fence()
        if self._promoting:
            raise PromotionInProgressError(
                "standby promotion in progress: the key->slot index is "
                "being rebuilt; retry after the promotion window")

    def _assign_slot(self, algo: str, lid: int, key: str,
                     hold_pin: bool = False) -> int:
        self._check_not_promoting()
        if self._fenced_shards:
            self._check_fence_keys([lid], [key])
        index = self._index[algo]
        pinned = self._batcher.pending_slots(algo)
        slot, evicted = index.assign((lid, key), pinned=pinned,
                                     hold_pin=hold_pin)
        if evicted is not None:
            if self._serving is not None:
                # Invalidate at remap time, not clear time: the evicted
                # key's index entry is already gone.
                self._serving.invalidate_slots(algo, [evicted])
            self._batcher.add_clear(algo, evicted)
        return slot
