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

Every stream loop runs the reference's pipeline
(:meth:`GpuBatchedStorage._run_chunks`): the next chunk's slot assign is
prefetched on a worker thread, each chunk's lanes are written into
reusable staging buffers (:class:`_StagingPool`, page-locked on a card, so
an upload never waits for the queued steps), each result is copied into
such a buffer right behind its step with a CUDA event after it, and the
chunks' drains wait on their own events on a pool of workers
(:class:`_DrainSet`), so decoding chunk k overlaps walking chunk k+1.
The sharded relay stream's per-shard lanes run the same pieces
(:class:`_ShardLane`).

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

A storage built over a given ``engine=`` serves that engine: the sharded
one (``parallel/sharded.py:ShardedDeviceEngine``, slots split over
several devices, or several shards of one) brings its table, its slot
count and its per-shard index (``ShardedSlotIndex``; no partitions).  Its
micro route splits each batch by shard; its int and string streams take
the reference's sharded routes (:meth:`GpuBatchedStorage.
_stream_relay_sharded`, :meth:`GpuBatchedStorage._stream_sharded`); scoped
fences (``fence(epoch, shards=...)``) refuse only the named shards' keys.

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
import math
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
from ratelimiter_tpu_torch.engine.device_rates import (
    FALLBACK_RATES as _FB_RATES,
    get_device_rates,
)
from ratelimiter_tpu_torch.engine.engine import DeviceEngine
from ratelimiter_tpu_torch.engine.errors import (
    OverloadedError,
    consume_pending_clears,
)
from ratelimiter_tpu_torch.engine.flush_control import AdaptiveFlushController
from ratelimiter_tpu_torch.engine.native_index import (
    NativeSlotIndex,
    hash_str_keys,
    rebuild_words_into,
    relay_decide,
    route_hashes_gather,
    shard_route_gather,
    sort_uniques,
    split_layout,
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
from ratelimiter_tpu_torch.ops import transfer
from ratelimiter_tpu_torch.ops.relay import wire_costs
from ratelimiter_tpu_torch.parallel.sharded import (
    ShardedSlotIndex,
    _bucket as _shard_bucket,
)
from ratelimiter_tpu_torch.storage.base import RateLimitStorage
from ratelimiter_tpu_torch.storage.errors import (
    FencedError,
    PromotionInProgressError,
)
from ratelimiter_tpu_torch.storage.memory import InMemoryStorage
from ratelimiter_tpu_torch.utils.logging import get_logger
from ratelimiter_tpu_torch.utils.tracing import (
    STREAM_ASSIGN,
    STREAM_ASSIGN_WAIT,
    STREAM_DISPATCH,
    STREAM_DRAIN,
    STREAM_DRAIN_WAIT,
    DecisionTrace,
    span,
)

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
# Chunk plans under a link profile (the reference's constants,
# :meth:`GpuBatchedStorage._elect_chunk_plan`): a candidate schedule
# replaces giant chunks when the simulator puts it below this share of the
# giant pass's simulated wall; a pipelined plan whose best measured pass
# stays above this multiple of the giant pass's measured wall reverts; the
# simulator's link runs at this share of the probed rate (a dispatch's
# transfer runs below the bulk probe's).
_PIPELINE_WIN_MARGIN = 0.97
_PIPELINE_REVERT = 1.1
_DISPATCH_RATE_DERATE = 0.55
# Host seconds a unique of the split digest's layout (native_index.
# split_layout) and of the slot sort (sort_uniques) costs, as the
# reference charges them in its elections.
_SPLIT_HOST_S_PER_UNIQUE = 15e-9
_SORT_HOST_S_PER_UNIQUE = 50e-9
# The partitioned host index's election (the reference's constants): from
# this many slots, min(cores, _HOST_PARALLEL_AUTO_MAX) partitions.
_HOST_PARALLEL_AUTO_MIN_SLOTS = 1 << 16
_HOST_PARALLEL_AUTO_MAX = 8
# The sharded relay stream (the reference's): chunks the main thread may
# route ahead of the oldest one still assembling on the shard lanes, and
# undrained dispatches one shard's lane holds before its submit waits.
_SHARD_LOOKAHEAD = 2
_SHARD_DRAIN_INFLIGHT = 2
# The sharded streams' route election (the reference's, storage/tpu.py:
# 3004-3059): chunks below this many requests take the host router without
# electing; the first chunk at or above it A/Bs the host router against
# the engine's device route once a storage, unless
# RATELIMITER_DEVICE_ROUTE (on | off | auto) fixes the route.
_ROUTE_ELECT_MIN = 1 << 16
# The relay's modes under the reference's names in ``stream_stats``: by
# what goes up.
_REF_RELAY_MODES = {"relay": "digest", "resident": "digest",
                    "words": "bits", "split": "split"}
# The port's own fields of a ``stream_stats`` record of the relay,
# weighted and flat loops, beyond the reference's, each in seconds: the
# calling thread's wait for the chunk's assign, and of string keys the
# hashing and its key packing.
PORT_CHUNK_FIELDS = ("assign_wait_s", "hash_s", "key_pack_s")
# The flat stream loops' pipeline (the reference's): drain workers waiting
# on chunks' results at once, and drains a pass keeps in flight before its
# next submit waits out the oldest.
_DRAIN_WORKERS = 4
_DRAIN_INFLIGHT = 4
# Host dtypes of the stream steps' result tensors (their landing buffers).
_HOST_DTYPES = {torch.uint8: np.uint8, torch.uint16: np.uint16,
                torch.int32: np.int32, torch.int64: np.int64}


def elect_host_parallel(num_slots: int, checkpointable: bool = False,
                        sharded: bool = False) -> int:
    """The partition count the reference's storage elects for the host
    slot index (``TpuBatchedStorage._auto_host_parallel``): 0 (one index)
    under ``checkpointable`` (the keyed index), for a ``sharded`` engine
    (its index is split per shard already), below
    ``_HOST_PARALLEL_AUTO_MIN_SLOTS`` slots or on a host of at most two
    cores (``os.sched_getaffinity``), else min(cores,
    ``_HOST_PARALLEL_AUTO_MAX``) walked down to the largest count that
    divides ``num_slots`` (0 when that reaches 1).

    The reference's other condition holds by construction here: the
    port's C index builds or raises, where the reference elects 0 when its
    library did not load."""
    if (checkpointable or sharded
            or num_slots < _HOST_PARALLEL_AUTO_MIN_SLOTS):
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


def _bucket_pow2(n: int) -> int:
    """The reference's power-of-two lane bucket, at least 4096: the chunk
    plan's simulator sizes a dispatch's lanes with it."""
    return _shard_bucket(n, floor=4096)


def _elect_digest_mode(link_profile, u: int, cn: int, n_delta: int,
                       digest_bpu: float, words_bpr: float,
                       srt_ok: bool, cdt_size: int = 1,
                       rates: dict | None = None) -> bool:
    """The relay's words-or-digest election for one chunk of ``cn``
    requests and ``u`` uniques, as the reference's
    (``storage/tpu.py:_elect_digest_mode``).

    Under a link profile ``(up, rtt, down)`` it compares each mode's whole
    seconds: the wire charged a direction at a time (the digest sends 4 B
    a unique and gets ``cdt_size`` back; words mode sends 4 B a request
    and gets a bit back) plus the device step at ``rates`` (the digest's
    sorted or unsorted rate by ``srt_ok``).  Without one it compares the
    bytes alone: the digest (``n_delta`` padded lid pairs charged at 1 /
    ``_DELTA_AMORT``) when it ships no more than words mode."""
    if link_profile is not None:
        up = max(link_profile[0], 1.0)
        down = max(link_profile[2], 1.0) if len(link_profile) > 2 else up
        if rates is None:
            rates = _FB_RATES
        dev_u = rates["s_per_unique_sorted" if srt_ok
                      else "s_per_unique_unsorted"]
        # The blended per-lane bytes hold the download part; it is
        # charged at the download rate.
        dig_cost = (u * ((digest_bpu - cdt_size) / up + cdt_size / down
                         + dev_u)
                    + (8 * n_delta / _DELTA_AMORT) / up)
        words_cost = cn * ((words_bpr - 0.125) / up + 0.125 / down
                           + rates["s_per_lane"])
        return dig_cost <= words_cost
    return digest_bpu * u + 8 * n_delta / _DELTA_AMORT <= words_bpr * cn


def _sort_affordable(link_profile, u: int) -> bool:
    """Whether to spend host time sorting a digest chunk's ``u`` uniques
    by slot, as the reference decides (``storage/tpu.py:
    _sort_affordable``).  ``RATELIMITER_SORT_UNIQUES=always|never|auto``
    (auto by default) is read at each call, so a change takes effect at
    once.  Under auto: yes on a host of more than two cores or without a
    link profile; else only where the chunk's upload (4 B a unique at the
    profiled rate) outlasts twice the sort's host time
    (``_SORT_HOST_S_PER_UNIQUE`` a unique)."""
    policy = os.environ.get("RATELIMITER_SORT_UNIQUES", "auto")
    if policy == "always":
        return True
    if policy == "never":
        return False
    try:
        cores = len(os.sched_getaffinity(0))
    except (AttributeError, OSError):  # not Linux
        cores = os.cpu_count() or 1
    if cores > 2 or link_profile is None:
        return True
    rate = max(link_profile[0], 1.0)
    return 4.0 / rate > 2.0 * _SORT_HOST_S_PER_UNIQUE


class _ChunkCursor:
    """Chunk sizing of the stream loops (the reference's): a pipelined
    plan's fixed ``schedule`` (its last entry sizes any overflow, when a
    longer stream of the same band reuses the plan), a pipelined plan's
    fixed ``chunk``, or the growth chunk, starting at ``_RELAY_CHUNK``.
    ``next_size`` takes the next size, ``peek`` reads it without taking
    it, and ``grow`` sets the growth chunk."""

    __slots__ = ("sched", "chunk", "ci")

    def __init__(self, plan, pipelined: bool):
        self.sched = plan.get("schedule") if pipelined else None
        self.chunk = (plan["chunk"] if pipelined and not self.sched
                      else _RELAY_CHUNK)
        self.ci = 0

    def _cur(self) -> int:
        if self.sched:
            return (self.sched[self.ci] if self.ci < len(self.sched)
                    else self.sched[-1])
        return self.chunk

    def next_size(self, remaining: int) -> int:
        c = min(self._cur(), remaining)
        if self.sched:
            self.ci += 1
        return c

    def peek(self, remaining: int) -> int:
        return min(self._cur(), remaining)

    def grow(self, chunk: int) -> None:
        self.chunk = chunk


def _schedule_candidates(n: int, head: int, words_pow2: bool) -> list:
    """Candidate chunk schedules for a pipelined pass of ``n`` requests
    (the reference's): a ``head`` chunk, big middle chunks, a small tail.
    With ``words_pow2`` (words mode pads its request lane to a power of
    two) every size is a power of two: a halving cascade and equal 2M
    middles.  Otherwise (the digest pads its unique lane) also two big
    middles and a tail, and one big middle and a tail.  No chunk passes
    ``_RELAY_CHUNK_MAX``; a remainder under ``_RELAY_CHUNK`` folds into
    the last chunk (:func:`_fold_tail`).  Streams under 4 *
    ``_RELAY_CHUNK`` get none."""
    floor = _RELAY_CHUNK
    if n < 4 * floor:
        return []
    cands = []
    sizes = [head]
    rem = n - head
    while rem >= floor:
        c = 1 << (int(rem).bit_length() - 1)
        c = min(max(min(c, rem), floor), _RELAY_CHUNK_MAX)
        sizes.append(int(c))
        rem -= c
    if rem > 0:
        _fold_tail(sizes, int(rem))
    cands.append(sizes)
    if not words_pow2:
        tail = max(floor, n // 16)
        mid = n - head - 2 * tail
        if mid > 2 * floor:
            half = (mid + 1) // 2
            if half <= _RELAY_CHUNK_MAX:
                cands.append([head, half, mid - half, tail, tail])
        big = n - head - tail
        if floor < big <= _RELAY_CHUNK_MAX:
            cands.append([head, big, tail])
    else:
        c = 4 * floor
        sizes2 = [head]
        rem = n - head
        while rem >= c:
            sizes2.append(c)
            rem -= c
        if rem > 0:
            _fold_tail(sizes2, int(rem))
        if len(sizes2) <= 40:
            cands.append(sizes2)
    return cands


def _fold_tail(sizes: list, rem: int) -> None:
    """Fold a remainder under ``_RELAY_CHUNK`` into a schedule's last
    chunk (the last entry sizes overflow chunks, so it must not be a
    crumb); past ``_RELAY_CHUNK_MAX`` the total splits in two halves
    instead."""
    total = sizes[-1] + rem
    if total <= _RELAY_CHUNK_MAX:
        sizes[-1] = total
    else:
        sizes[-1] = total // 2
        sizes.append(total - total // 2)


def _sim_schedule_wall(sizes, *, cpu_per_req: float, digest_frac: float,
                       dedup_a: float, dedup_alpha: float, bpu_up: float,
                       bpu_down: float, words_up: float, link_up: float,
                       link_down: float, rtt: float,
                       dev_per_lane: float) -> float:
    """Predicted wall of one schedule (the reference's model, used to rank
    candidates): the host's walk and layout serialize on one timeline,
    the link's bytes on another, and each chunk's fetch completes one
    round trip after its step's wire and device time.  A digest pass
    (``digest_frac`` > 0.5) ships ``dedup_a * c^dedup_alpha`` uniques a
    chunk of ``c``, padded to :func:`_bucket_pow2`; words mode ships the
    padded requests and a bit each back."""
    t_cpu = 0.0
    link_free = 0.0
    done = 0.0
    for c in sizes:
        t_cpu += c * cpu_per_req
        if digest_frac > 0.5:
            u = min(c, dedup_a * (c ** dedup_alpha))
            lanes = _bucket_pow2(max(int(u), 1))
            up_b, down_b = bpu_up * lanes, bpu_down * lanes
        else:
            lanes = _bucket_pow2(int(c))
            up_b, down_b = words_up * lanes, c / 8.0
        start = max(t_cpu, link_free)
        link_free = start + up_b / link_up + down_b / link_down
        done = max(done, link_free + lanes * dev_per_lane + rtt)
    return done


# Injectable per-process clock offset (the reference's
# ``storage/tpu.py:_CLOCK_SKEW_MS``): every default now-source of this
# module reads wall time PLUS this skew, so cross-node clock skew and
# step jumps are testable against a real clock.  Seeded from
# RATELIMITER_CLOCK_SKEW_MS so a spawned node process can boot skewed;
# mutable at runtime through ``set_clock_skew_ms`` (the node's ``skew``
# control op, replication/hostproc.py).  Storages built with an explicit
# ``clock_ms=`` are unaffected.
_CLOCK_SKEW_MS: int = int(os.environ.get("RATELIMITER_CLOCK_SKEW_MS",
                                         "0") or "0")


def set_clock_skew_ms(skew_ms: int) -> int:
    """Set this process's injected clock offset (ms, may be negative);
    returns the previous value.  Takes effect on the next clock read."""
    global _CLOCK_SKEW_MS
    prev = _CLOCK_SKEW_MS
    _CLOCK_SKEW_MS = int(skew_ms)
    return prev


def clock_skew_ms() -> int:
    return _CLOCK_SKEW_MS


def _wall_clock_ms() -> int:
    return time.time_ns() // 1_000_000 + _CLOCK_SKEW_MS


def _pow2(n: int) -> int:
    """Smallest power of two >= max(n, 1)."""
    return 1 << max(int(n) - 1, 0).bit_length()


def check_tb_permits(algo: str, permits) -> None:
    """Refuse a negative token-bucket permit (one value or an array) with
    ``ValueError``; every storage surface that takes token-bucket permits
    calls it before touching any state.  The solver kernel's contract is
    ``w >= 0``, and its plain version iterates on negative weights as the
    reference's XLA solver does, so the card and the CPU would decide such
    a request two ways; the oracle and the limiters refuse it.  Permit 0
    and sliding-window permits pass (ROADMAP port rules)."""
    if algo != "tb" or permits is None:
        return
    if np.ndim(permits) == 0:
        bad = int(permits) < 0
    else:
        p = np.asarray(permits)
        bad = bool(p.size) and int(p.min()) < 0
    if bad:
        raise ValueError("negative token-bucket permits")


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


class _DrainSet:
    """Drains in flight (the reference's ``storage/tpu.py:_DrainSet``):
    each dispatched chunk's drain goes to a pool at once, so the waits of
    consecutive chunks overlap each other and the host's walk of the next
    chunk.  ``submit`` past ``inflight`` live drains (``_DRAIN_INFLIGHT``
    by default) calls ``on_block`` and waits out the oldest, which bounds
    the result buffers held; ``finish()`` waits for every drain and
    re-raises the first error; ``finish(swallow=True)`` is for a path
    already propagating its own exception."""

    __slots__ = ("_pool", "_futs", "_inflight", "_on_block")

    def __init__(self, pool, inflight: int | None = None, on_block=None):
        self._pool = pool
        self._futs: List[Future] = []
        self._inflight = _DRAIN_INFLIGHT if inflight is None else inflight
        self._on_block = on_block

    def submit(self, fn, *args) -> None:
        self._futs.append(self._pool.submit(fn, *args))
        live = [f for f in self._futs if not f.done()]
        if len(live) > self._inflight:
            if self._on_block is not None:
                self._on_block()
            live[0].result()

    def finish(self, swallow: bool = False) -> None:
        err = None
        for f in self._futs:
            try:
                f.result()
            except Exception as exc:  # noqa: BLE001 — re-raised below
                if err is None:
                    err = exc
        self._futs.clear()
        if err is not None and not swallow:
            raise err


class _StagingPool:
    """Reusable host buffers of the stream dispatches (the reference's
    ``storage/tpu.py:_StagingPool``).  ``take(shape, dtype)`` returns a
    C-contiguous array of that shape with unspecified contents (the
    caller writes its lanes and re-fills its own padding); ``give(buf,
    event)`` returns one once the chunk that used it has landed, keyed by
    shape and dtype, up to ``max_bytes`` retained (past that it is
    dropped; a miss allocates).  Lane counts are bucketed, so shapes recur.

    With ``pinned`` (a CUDA storage) the buffers are page-locked host
    memory (``torch.empty(..., pin_memory=True)``, handed out as numpy
    views), so an upload from one is truly asynchronous and a buffer
    given back early would be overwritten before its copy read it.  The
    stream loops give a buffer back only after its chunk's CUDA event;
    ``give`` keeps that event, and a ``take`` of a buffer whose event is
    still pending counts in ``early`` (it must stay 0).  ``takes`` and
    ``hits`` count the calls and the reuses."""

    __slots__ = ("_free", "_lock", "_bytes", "_max_bytes", "pinned",
                 "takes", "hits", "early")

    def __init__(self, max_bytes: int = 256 << 20, pinned: bool = False):
        self._free: Dict[tuple, list] = {}
        self._lock = threading.Lock()
        self._bytes = 0
        self._max_bytes = int(max_bytes)
        self.pinned = bool(pinned)
        self.takes = 0
        self.hits = 0
        self.early = 0

    def take(self, shape, dtype) -> np.ndarray:
        shape = ((int(shape),) if np.ndim(shape) == 0
                 else tuple(int(d) for d in shape))
        dtype = np.dtype(dtype)
        key = (shape, dtype.str)
        with self._lock:
            self.takes += 1
            lst = self._free.get(key)
            if lst:
                arr, event = lst.pop()
                self._bytes -= arr.nbytes
                self.hits += 1
                if event is not None and not event.query():
                    self.early += 1
                return arr
        if not self.pinned:
            return np.empty(shape, dtype=dtype)
        nbytes = int(np.prod(shape)) * dtype.itemsize
        block = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                            pin_memory=True)
        return block.numpy()[:nbytes].view(dtype).reshape(shape)

    def give(self, arr, event=None) -> None:
        if arr is None:
            return
        key = (arr.shape, arr.dtype.str)
        with self._lock:
            if self._bytes + arr.nbytes > self._max_bytes:
                return  # over budget: the allocator takes it back
            self._free.setdefault(key, []).append((arr, event))
            self._bytes += arr.nbytes

    def stats(self) -> dict:
        with self._lock:
            return {"takes": self.takes, "hits": self.hits,
                    "misses": self.takes - self.hits, "early": self.early,
                    "retained_bytes": self._bytes}


class _Landing:
    """One dispatched result on its way to the host: ``host`` its page-
    locked landing buffer and ``event`` the CUDA event behind the copy
    (``ops/transfer.py:land``), or, on the CPU, the result's own array and
    no event; ``pool`` takes ``host`` back once the drain decoded it."""

    __slots__ = ("host", "event", "pool")

    def __init__(self, host: np.ndarray, event=None, pool=None):
        self.host = host
        self.event = event
        self.pool = pool

    def wait(self) -> None:
        """Block (GIL released) until the copy has landed."""
        if self.event is not None:
            self.event.synchronize()

    def release(self) -> None:
        if self.pool is not None:
            self.pool.give(self.host, self.event)


class _ShardLane:
    """One shard's pipeline in the sharded relay stream (the reference's
    ``storage/tpu.py:_ShardLane``): ``pipe``, one FIFO worker running the
    shard's assign, eviction clears, layout and dispatch chunk after
    chunk (so a shard's clears enter its stream ahead of the dispatch
    that reuses the slots, with no barrier across shards); ``staging``,
    its own :class:`_StagingPool` of 64 MiB (page-locked on a card); and
    ``drains``, a :class:`_DrainSet` on its own fetch worker, at most
    ``_SHARD_DRAIN_INFLIGHT`` behind.  Past that a submit waits, counted
    in ``saturated`` and recorded to the flight recorder as
    ``shard.drain_saturated`` (coalesced over a second)."""

    __slots__ = ("shard", "pipe", "drain_pool", "staging", "drains",
                 "saturated")

    def __init__(self, shard: int, recorder=None, pinned: bool = False):
        import concurrent.futures as cf

        self.shard = shard
        self.pipe = cf.ThreadPoolExecutor(
            1, thread_name_prefix=f"shard{shard}-pipe")
        self.drain_pool = cf.ThreadPoolExecutor(
            1, thread_name_prefix=f"shard{shard}-drain")
        self.staging = _StagingPool(max_bytes=64 << 20, pinned=pinned)
        self.saturated = 0

        def on_block():
            self.saturated += 1
            if recorder is not None:
                recorder.record("shard.drain_saturated",
                                coalesce_ms=1000.0, shard=self.shard)

        self.drains = _DrainSet(self.drain_pool, _SHARD_DRAIN_INFLIGHT,
                                on_block)

    def close(self) -> None:
        self.pipe.shutdown(wait=False)
        self.drain_pool.shutdown(wait=False)


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
        engine=None,
    ):
        self.device = (engine.device if engine is not None
                       else resolve_device(device))
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
        # A given engine (the sharded one, parallel/sharded.py) brings
        # its table and its slot count.
        if engine is not None:
            self.table = engine.table
            self.engine = engine
            num_slots = engine.num_slots
        else:
            self.table = LimiterTable(
                capacity=table_capacity if table_capacity > 0 else 64,
                device=self.device)
            self.engine = DeviceEngine(num_slots, self.table,
                                       device=self.device)
        sharded = hasattr(self.engine, "n_shards")
        self._configs: Dict[int, Tuple[str, RateLimitConfig]] = {}
        # The host slot index, one per algorithm: partitioned over
        # host_parallel sub-indexes when that is above 1 (None elects the
        # count as the reference does, 0 turns partitions off); the keyed
        # index under checkpointable=True, whose dumps carry the keys; for
        # a sharded engine one sub-index per shard (C, or keyed under
        # checkpointable=True).
        if host_parallel is None:
            host_parallel = elect_host_parallel(num_slots, checkpointable,
                                                sharded)
        self._host_parallel = (int(host_parallel)
                               if host_parallel and host_parallel > 1 else 0)
        if self._host_parallel and sharded:
            raise ValueError(
                "host_parallel applies to single-device engines; the "
                "sharded engine already splits the host index per shard")
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
            if sharded:
                return ShardedSlotIndex(self.engine.slots_per_shard,
                                        self.engine.n_shards,
                                        native=not checkpointable)
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
        # scopes a fence to shards of a sharded engine (on one engine a
        # scoped fence refuses nothing).  Token leases revoke
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
        # The reference's per-chunk stream records: None (off, at no
        # cost) or a list the stream loops append one record a chunk to
        # (:meth:`_stream_rec`), filled from ``last_stream_chunks``.
        self.stream_stats: list | None = None
        # The sharded streams' route, host or device: None until the
        # first chunk of 2^16 requests or more elects it
        # (:meth:`_route_sharded`).
        self._route_mode: str | None = None
        # The host <-> device link profile (up bytes/s, round-trip s, down
        # bytes/s) the streams elect under, None until set_link_profile or
        # probe_link; the chunk plan per stream shape (the reference's
        # records, :meth:`_elect_chunk_plan`); the device rates the
        # elections charge once a profile is set, probed at first use.
        self._link_profile: Tuple[float, float, float] | None = None
        self._chunk_plans: Dict[tuple, dict] = {}
        self._device_rates_obj: dict | None = None
        # The sharded relay stream's shard lanes and the pool of the
        # sharded flat stream's per-shard assigns, made at first use.
        self._shard_lanes_obj: List[_ShardLane] | None = None
        self._shard_pool_obj = None
        # The flat stream loops' pipeline (:meth:`_run_chunks`): the
        # one-worker pool that prefetches the next chunk's assign and the
        # drain workers, made at first use; the staging buffers of the
        # dispatches' lanes and landed results (page-locked on a card);
        # and the lock the drains record their meters under.
        self._assign_pool_obj = None
        self._drain_pool_obj = None
        self._staging = _StagingPool(pinned=self.device.type == "cuda")
        self._drain_lock = threading.Lock()
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
        check_tb_permits(algo, permits)
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
        check_tb_permits(algo, permits)
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
        check_tb_permits(algo, permits)
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
        check_tb_permits(algo, permits)
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
        check_tb_permits(algo, permits)
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
        below int32 raise ValueError, and so does a negative
        token-bucket permit (:func:`check_tb_permits`); permits above
        2^31-1 exceed every limiter's max_permits and are denied without
        touching state.

        Routes, as the reference's (``ratelimiter_tpu/storage/tpu.py``):
        permits in [1, 255] of one limiter, none oversize, take the
        weighted relay (:meth:`_stream_weighted`); unit permits under
        limits below the relay word's count clamp the relay
        (:meth:`_stream_relay`, which elects each chunk's mode); the rest
        the flat sorted step in super-batches of ``batch * subbatches``
        requests (:meth:`_stream_flat`).  The keyed index
        (``checkpointable=True``) takes none of them: its stream goes in
        synchronous batches of ``batch`` requests (:meth:`_stream_keyed`).

        A sharded engine's stream takes the reference's sharded routes:
        unit permits under limits below the relay word's clamp the
        per-shard relay lanes (:meth:`_stream_relay_sharded`), everything
        else the flat sorted step on every shard (:meth:`_stream_sharded`)."""
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
        check_tb_permits(algo, permits)
        index = self._index[algo]
        if isinstance(index, ShardedSlotIndex) and index.supports_batch_ints:
            self._batcher.flush()
            return self._stream_sharded(
                algo, lid, np.ascontiguousarray(key_ids, dtype=np.int64),
                permits, oversize, batch, subbatches, index, lid_arr)
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
        seconds go into each chunk record's ``hash_s`` (and the
        reference's ``pack_s``), the key packing's into ``key_pack_s``.
        Keys share the (lid, key) namespace of
        :meth:`acquire_many` and :meth:`acquire`.  Decisions equal
        :meth:`acquire_many` on the same chunks.

        The keyed index (``checkpointable=True``) takes the reference's
        fallback: synchronous batches of ``batch`` requests
        (:meth:`_stream_keyed`).  On a sharded engine unit permits under
        limits below the relay word's clamp take the per-shard relay lanes
        (:meth:`_stream_relay_sharded`, routed by each key's fingerprint
        h1); other permits take the same synchronous batches, as the
        reference's do."""
        self._check_not_promoting()
        if self._fenced_shards:
            self._check_fence_keys([lid] * len(keys), keys)
        raw_permits = permits
        permits, oversize = self._stream_permits(permits)
        check_tb_permits(algo, permits)
        index = self._index[algo]
        if (isinstance(index, ShardedSlotIndex) and index.supports_batch_strs
                and permits is None and self.engine.relay_usable()):
            self._batcher.flush()
            return self._stream_relay_sharded(
                algo, int(lid), keys if isinstance(keys, list)
                else list(keys), index, None, key_kind="strs")
        if not hasattr(index, "assign_batch_strs"):
            return self._stream_keyed(algo, [int(lid)] * len(keys),
                                      list(keys), raw_permits, batch)
        self._batcher.flush()
        eng = self.engine
        rb = eng.rank_bits
        lid = int(lid)
        n = len(keys)
        hashing = {}  # the last walk's hash_s and key_pack_s

        def fingerprints(start, count):
            return hash_str_keys(keys, lid, start, count, timing=hashing)

        def hash_times():
            return hashing["hash_s"], hashing["key_pack_s"]

        def walk_u(start, count, pinned):
            return index.assign_batch_fps_uniques(
                *fingerprints(start, count), rb, pinned=pinned,
                hold_pins=True)
        if self._weighted_permits(permits, oversize):
            return self._stream_weighted(
                algo, lid, n, np.ascontiguousarray(permits, dtype=np.int64),
                walk_u, hash_times=hash_times)
        if permits is None and eng.relay_usable():
            return self._stream_relay(algo, lid, n, walk_u,
                                      hash_times=hash_times)

        def walk(start, count, pinned):
            return index.assign_batch_fps(*fingerprints(start, count),
                                          pinned=pinned, hold_pins=True)
        return self._stream_flat(algo, lid, n, walk, permits, oversize,
                                 batch, subbatches, None,
                                 hash_times=hash_times)

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

    def _run_chunks(self, algo: str, n: int, cursor: _ChunkCursor, assign,
                    dispatch, hash_times=None, tot: dict | None = None,
                    t_pass0: float | None = None,
                    stat: str = "flat") -> np.ndarray:
        """The stream loops' one pipeline (the reference's, built around
        CUDA events).  Chunk sizes come from ``cursor``
        (:class:`_ChunkCursor`), which a dispatch may ``grow``.  Per chunk
        k, on the calling thread:

        1. take k's assign: the prefetched one, or a direct call for the
           first chunk.  ``assign(start, count)`` runs the C index with the
           chunk's slots pinned and returns (the pinned slots, the
           evictions, a payload);
        2. under the pins, clear the evictions and call ``dispatch(start,
           count, payload, rec)``, which enqueues the chunk's steps and
           returns ``(path, lid, parts, bufs)``: the route's name, its one
           limiter (None for a lid array), the ``(result tensor,
           decode)`` pairs, and the staging buffers its uploads read.  Each
           result is landed at once, in stream order right behind its step
           (:meth:`_land`: on a card a copy into a page-locked buffer and a
           CUDA event after it); then the pins are released;
        3. submit chunk k+1's assign to :meth:`_assign_pool`, sized by
           ``cursor.peek``;
        4. submit chunk k's drain to a :class:`_DrainSet` on
           :meth:`_drain_pool`: it waits on its own chunk's events only
           (never on a later chunk's step), decodes, writes
           ``out[start:start + count]``, records ``fetch`` and the dispatch
           (:meth:`_fetch`), and gives its buffers back to the staging
           pool, the uploads' after the event too.

        At the end ``finish()`` re-raises the first drain error.  On any
        exception the orphaned prefetch is consumed
        (:meth:`_abort_prefetch`: its evictions cleared, its pins
        released) and the drains are waited out without their errors.

        Each chunk's record ``rec`` goes into ``last_stream_chunks``: its
        mode, sizes and host timings in seconds (``assign_wait_s``, how
        long the calling thread waited for the chunk's assign: the whole
        direct assign of the first chunk, the wait on a prefetched one;
        for string keys ``hash_s`` and ``key_pack_s``, which the caller's
        ``hash_times()`` gives as the last assign's hashing share of
        ``assign_s`` and the key packing's share of that, and ``pack_s``,
        the hashing under the reference's name; under a partitioned index
        its partition count as ``host_parallel``), ``walk_at`` and
        ``fetch_at`` (the assign's and the drain's event waits' windows
        from the pass's start ``t_pass0``), ``fetch_s`` (the waits),
        ``drain_s`` (the whole drain) and, on a card, ``step_ms`` (the
        device's span from the chunk's first clear or upload to its last
        landed result) and ``host_s`` (from the assign's end to the
        landed results).  With ``stream_stats`` set, the finished pass's
        records go there too as the reference's loop ``stat`` (``relay``,
        ``relay_w`` or ``flat``) records them (:meth:`_chunk_stats`).
        ``tot``, a chunk plan's pass totals
        (:meth:`_plan_setup`), takes the walk seconds (``walk_s``), each
        chunk's host seconds from its assign's end to its enqueue
        (``host_s``) and the waits (``fetch_s``), under its ``_lock``:
        assigns and drains run on other threads.

        Spans (``utils/tracing.py:span``) on the calling thread:
        ``rl.stream.assign`` over the first chunk's assign,
        ``rl.stream.assign_wait`` over the wait on a prefetched one,
        ``rl.stream.dispatch`` over the window ``host_s`` times and
        ``rl.stream.drain_wait`` over the wait on the pass's drains; on
        the drain pool ``rl.stream.drain`` over each chunk's drain.
        Returns bool[n] allowed."""
        index = self._index[algo]
        out = np.empty(n, dtype=bool)
        chunks: List[dict] = []
        self.last_stream_chunks = chunks
        lock = tot["_lock"] if tot is not None else threading.Lock()
        if t_pass0 is None:
            t_pass0 = time.perf_counter()
        on_card = self.device.type == "cuda"

        def timed_assign(start: int, count: int):
            t0 = time.perf_counter()
            pins, clears, payload = assign(start, count)
            t1 = time.perf_counter()
            self._stage("index", t1 - t0)
            if tot is not None:
                with lock:
                    tot["walk_s"] += t1 - t0
            # The evictions last, as _abort_prefetch reads them.
            return (count, payload, t1 - t0,
                    None if hash_times is None else hash_times(),
                    [t0 - t_pass0, t1 - t_pass0], pins, clears)

        def drain(start, count, rec, path, lid, parts, landings, bufs, ev0,
                  t0):
            with span(STREAM_DRAIN):
                try:
                    got, waits = [], []
                    for (_, decode), land in zip(parts, landings):
                        got.append(self._fetch(algo, path, t0, land, decode,
                                               lid, waits))
                    out[start:start + count] = (got[0] if len(got) == 1
                                                else np.concatenate(got))
                    with lock:
                        rec["fetch_s"] = sum(b - a for a, b in waits)
                        rec["fetch_at"] = [waits[0][0] - t_pass0,
                                           waits[-1][1] - t_pass0]
                        rec["drain_s"] = time.perf_counter() - waits[0][0]
                        if ev0 is not None:
                            rec["step_ms"] = ev0.elapsed_time(
                                landings[-1].event)
                        if tot is not None:
                            tot["fetch_s"] += rec["fetch_s"]
                finally:
                    self._give_back(landings, bufs, self._staging)

        drains = _DrainSet(self._drain_pool())
        fut = None  # the prefetched next assign (holds its pins)
        start = 0
        try:
            while start < n:
                cn = cursor.next_size(n - start)
                t_w0 = time.perf_counter()
                if fut is not None:
                    with span(STREAM_ASSIGN_WAIT):
                        item = fut.result()
                    fut = None
                else:
                    with span(STREAM_ASSIGN):
                        item = timed_assign(start, cn)
                count, payload, assign_s, hashed, walk_at, pins, clears = item
                rec = {"requests": count, "assign_s": assign_s,
                       "assign_wait_s": time.perf_counter() - t_w0,
                       "walk_at": walk_at}
                if self._host_parallel:
                    rec["host_parallel"] = self._host_parallel
                if hashed is not None:
                    rec["hash_s"], rec["key_pack_s"] = hashed
                    rec["pack_s"] = rec["hash_s"]
                chunks.append(rec)
                with span(STREAM_DISPATCH):
                    t_h0 = time.perf_counter()
                    ev0 = None
                    if on_card:
                        ev0 = torch.cuda.Event(enable_timing=True,
                                               blocking=True)
                        ev0.record()
                    with self._pins_released(index, pins):
                        if len(clears):
                            self._clear_slots(algo, list(clears))
                        path, lid, parts, bufs = dispatch(start, count,
                                                          payload, rec)
                        landings = [self._land(h, self._staging)
                                    for h, _ in parts]
                    rec["host_s"] = time.perf_counter() - t_h0
                if tot is not None:
                    with lock:
                        tot["host_s"] += rec["host_s"]
                if start + count < n:
                    fut = self._assign_pool().submit(
                        timed_assign, start + count,
                        cursor.peek(n - start - count))
                drains.submit(drain, start, count, rec, path, lid, parts,
                              landings, bufs, ev0, t_h0)
                start += count
            with span(STREAM_DRAIN_WAIT):
                drains.finish()
            if self.stream_stats is not None:
                self._chunk_stats(stat, chunks)
        finally:
            if fut is not None:
                self._abort_prefetch(algo, index, fut, lambda res: res[-2])
            drains.finish(swallow=True)
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
                      hash_times=None) -> np.ndarray:
        """The relay loop (:meth:`_run_chunks`) over ``n`` requests with
        unit permits of one limiter ``lid`` or of the per-request
        ``lid_arr``, assigned by ``walk`` (:meth:`_assign_uniques`).  Each
        chunk takes one of four modes, elected as the reference elects
        them (:func:`_elect_digest_mode`, and under a link profile the
        split election):

        - ``relay``, the digest of one limiter: the uniques, sorted by
          slot when there are many and :func:`_sort_affordable` allows,
          go up as words padded to a power of two with 0xFFFFFFFF; the
          per-unique allowed counts come back and the host rebuilds each
          request's decision as ``rank < counts[uidx]``;
        - ``resident``, the digest of a lid array: as ``relay``, with the
          (slot, lid) pairs the engine's lid map does not hold yet
          uploaded beside the words (padded with slot -1 to a power of
          two, at least ``_DELTA_FLOOR``), and marked held once the step
          is enqueued;
        - ``split``, the digest of one limiter under a link profile where
          it costs less than the digest or words mode elected before it:
          the singletons as a 3-byte slot plane with allow bits back, the
          other uniques as words with counts back
          (``native_index.split_layout``, each lane padded to
          :func:`_bucket_fine`);
        - ``words``: one word per request (slot | clamped rank | last,
          ``native_index.rebuild_words_into``) with the limiter id or a
          lid lane, packed allow bits back.  It takes duplicate-poor
          chunks, and every chunk when the counts fit no dtype.

        Chunks follow the shape's chunk plan (:meth:`_plan_setup`): a
        pipelined plan's schedule, or growth toward the mode's wire budget
        at the bytes per request the chunk shipped; the pass's totals
        then elect or revert the plan (:meth:`_plan_finish`).  Each
        chunk's record: its mode, uniques (``singles`` of a split chunk),
        the lid pairs uploaded (``deltas``, padded to ``delta_lanes``),
        ``wire_bytes``, and the layout (``sort_s`` of it the slot sort),
        enqueue and drain times."""
        eng = self.engine
        rb = eng.rank_bits
        cdt = eng.counts_dtype()
        cdt_size = np.dtype(cdt).itemsize if cdt is not None else 1
        multi = lid_arr is not None
        digest_bpu, words_bpr = wire_costs(multi)
        sw = algo == "sw"
        counts_dispatch = (eng.sw_relay_counts_dispatch if sw
                           else eng.tb_relay_counts_dispatch)
        split_dispatch = (eng.sw_relay_counts_split_dispatch if sw
                          else eng.tb_relay_counts_split_dispatch)
        resident_dispatch = (eng.sw_relay_counts_resident_dispatch if sw
                             else eng.tb_relay_counts_resident_dispatch)
        bits_dispatch = eng.sw_relay_dispatch if sw else eng.tb_relay_dispatch
        lock = self._lid_locks[algo]
        known = None
        if multi and cdt is not None:
            with lock:
                known = self._lid_known.setdefault(
                    algo, np.zeros(eng.num_slots, dtype=bool))
        # The plan key bands n by quarter octaves, so streams of jittering
        # lengths share a plan; int and string keys walk at different
        # costs and do not.
        plan_key = ("relay", "ints" if hash_times is None else "strs", algo,
                    multi, _bucket_fine(n, floor=_RELAY_CHUNK))
        plan, pipelined, tot, cursor, t_pass0 = self._plan_setup(plan_key)
        prof = self._link_profile
        rates = self._device_rates()

        def split_cost(uwords, u: int, count: int, digest: bool,
                       srt_ok: bool):
            """Whether the split costs less than the mode elected before
            it, under the profile's per-direction rates (the reference's
            split election)."""
            up_r = max(prof[0], 1.0)
            down_r = max(prof[2], 1.0) if len(prof) > 2 else up_r
            singles = (((uwords >> np.uint32(1))
                        & np.uint32((1 << rb) - 1)) == 1)
            n_singles = int(singles.sum())
            cost = (n_singles * (3.0 / up_r + 0.125 / down_r)
                    + (u - n_singles) * (4.0 / up_r + cdt_size / down_r)
                    + u * (rates["s_per_unique_unsorted"]
                           + _SPLIT_HOST_S_PER_UNIQUE))
            if digest:
                dev_u = rates["s_per_unique_sorted" if srt_ok
                              else "s_per_unique_unsorted"]
                rival = u * (4.0 / up_r + cdt_size / down_r + dev_u)
            else:
                rival = count * ((words_bpr - 0.125) / up_r
                                 + 0.125 / down_r + rates["s_per_lane"])
            return cost < rival

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
            # One sort verdict drives both the election's device rate and
            # the dispatch.
            srt_ok = u >= _SORT_UNIQUES_MIN and _sort_affordable(prof, u)
            digest = cdt is not None and _elect_digest_mode(
                prof, u, count, n_delta, digest_bpu, words_bpr, srt_ok,
                cdt_size=cdt_size, rates=rates)
            split = (prof is not None and cdt is not None and not multi
                     and rb >= 2 and eng.num_slots <= 0xFFFFFF
                     and u >= _SORT_UNIQUES_MIN
                     and split_cost(uwords, u, count, digest, srt_ok))
            srt = False
            take = self._staging.take
            if split:
                rec["mode"] = "split"
                s3, mwords, uidx2, n_s = split_layout(uwords, rb, uidx)
                rec["singles"] = n_s
                # Fine buckets, multiples of 8 (the bits pack by bytes):
                # power-of-two padding would waste the wire the split
                # saves.
                s_pad, m_pad = _bucket_fine(n_s), _bucket_fine(u - n_s)
                s3p = take((s_pad, 3), np.uint8)
                s3p[:n_s] = s3
                s3p[n_s:] = 0xFF
                mw = take(m_pad, np.uint32)
                mw[:u - n_s] = mwords
                mw[u - n_s:] = 0xFFFFFFFF
                bufs = [s3p, mw]
                t1 = time.perf_counter()
                handle = split_dispatch(s3p, mw, lid, now, cdt)

                def decode(arr):
                    # [singles' bits | multis' counts] -> one counts lane
                    # by the remapped unique index; a single's count is its
                    # bit.
                    counts = np.empty(u, dtype=cdt)
                    counts[:n_s] = np.unpackbits(arr[:s_pad // 8])[:n_s]
                    counts[n_s:] = arr[s_pad // 8:s_pad // 8
                                       + m_pad * cdt_size].view(
                                           cdt)[:u - n_s]
                    return relay_decide(counts, uidx2, rank)
                result = ("relay|split", [(handle, decode)])
                wire = 3.125 * s_pad + (4.0 + cdt_size) * m_pad
                digest = True
                budget = _RELAY_WIRE_BUDGET_DIGEST
            elif digest:
                if srt_ok:
                    sort_uniques(uwords, rb, uidx)
                    srt = True
                    rec["sort_s"] = time.perf_counter() - t0
                words = take(_pow2(u), np.uint32)
                words[:u] = uwords
                words[u:] = 0xFFFFFFFF
                bufs = [words]
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
                        d_slots = take(n_delta, np.int32)
                        d_slots[:nd] = us[fresh]
                        d_slots[nd:] = -1
                        d_lids = take(n_delta, np.int32)
                        d_lids[:nd] = ulids[fresh]
                        d_lids[nd:] = 0
                        bufs += [d_slots, d_lids]
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
                result = ("relay|digest", [
                    (counts[:u], lambda arr: relay_decide(arr, uidx, rank))])
                wire = digest_bpu * u + 8 * n_delta
                budget = _RELAY_WIRE_BUDGET_DIGEST
            else:
                rec["mode"] = "words"
                size = _pow2(count)
                words = take(size, np.uint32)
                rebuild_words_into(uwords, uidx, rank, rb, words[:count])
                words[count:] = 0xFFFFFFFF
                bufs = [words]
                lids = lid
                if multi:
                    lids = take(size, np.int32)
                    lids[:count] = lid_arr[start:start + count]
                    lids[count:] = 0
                    bufs.append(lids)
                t1 = time.perf_counter()
                bits = bits_dispatch(words, lids, now)
                result = ("relay|bits", [
                    (bits,
                     lambda arr: np.unpackbits(arr)[:count].astype(bool))])
                wire = words_bpr * count
                budget = _RELAY_WIRE_BUDGET_WORDS
            rec["layout_s"] = t1 - t0
            rec["enqueue_s"] = time.perf_counter() - t1
            rec["wire_bytes"] = int(wire)
            self._stage("layout", rec["layout_s"])
            self._stage("enqueue", rec["enqueue_s"])
            if "pack_s" in rec and not self._host_parallel:
                # The reference reads the hashing time off its single C
                # index; its partitioned index reports none.
                self._stage("pack", rec["pack_s"])
            with tot["_lock"]:
                tot["wire"] += wire
                tot["chunks"] += 1
                tot["cu"].append((int(count), int(u)))
                if digest:
                    tot["device_s"] += u * rates[
                        "s_per_unique_sorted" if srt
                        else "s_per_unique_unsorted"]
                    tot["digest_chunks"] += 1
                    tot["bpu"] = digest_bpu
                else:
                    tot["device_s"] += count * rates["s_per_lane"]
                    tot["bpr"] = words_bpr
            if not pipelined:
                bpr = max(wire / count, 1e-3)
                cursor.grow(int(min(max(budget / bpr, _RELAY_CHUNK),
                                    _RELAY_CHUNK_MAX)))
            return result[0], lid, result[1], bufs

        out = self._run_chunks(algo, n, cursor,
                               self._assign_uniques(algo, walk), dispatch,
                               hash_times, tot, t_pass0, "relay")
        self._plan_finish(plan_key, pipelined, n, tot, t_pass0)
        return out

    def _stream_weighted(self, algo: str, lid: int, n: int,
                         permits: np.ndarray, walk,
                         hash_times=None) -> np.ndarray:
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

        Chunks follow the shape's chunk plan (:meth:`_plan_setup`): a
        pipelined plan's schedule, or growth toward
        ``_RELAY_WIRE_BUDGET_WEIGHTED`` at the wire bytes per request the
        last chunk's mode took; the pass's totals then elect or revert the
        plan (:meth:`_plan_finish`).  Each chunk's record: its mode,
        uniques, ``wire_bytes``, and the layout, enqueue and drain
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
        plan_key = ("weighted", "ints" if hash_times is None else "strs",
                    algo, _bucket_fine(n, floor=_RELAY_CHUNK))
        plan, pipelined, tot, cursor, t_pass0 = self._plan_setup(plan_key)
        rates = self._device_rates()

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
            take = self._staging.take
            if wlane is not None:
                rec["mode"] = "weighted_coal"
                # Padded to a fine bucket, as the reference pads it, so
                # the staging buffers' shapes recur.
                u_b = _bucket_fine(max(u, 1))
                uw = take(u_b, np.uint32)
                uw[:u] = uwords
                uw[u:] = 0xFFFFFFFF
                wl = take(u_b, np.uint8)
                wl[:u] = wlane
                wl[u:] = 0
                bufs = [uw, wl]
                t1 = time.perf_counter()
                counts = coal_dispatch(uw, wl, lid, self._monotonic_now(),
                                       cdt)
                result = ("relay_w|weighted_coal", [
                    (counts[:u], lambda arr: relay_decide(arr, uidx, rank))])
                wire = (5 + np.dtype(cdt).itemsize) * u
                dev_s = u * rates["s_per_unique_unsorted"]
            elif r_max <= r_cap:
                rec["mode"] = "weighted"
                r_b = 2
                while r_b < r_max:
                    r_b *= 2
                u_b = _bucket_fine(u)
                uw_sorted = take(u_b, np.uint32)
                uw_sorted[u:] = 0xFFFFFFFF
                spos = np.empty(u, dtype=np.int32)
                roff = np.empty(r_b, dtype=np.int64)
                # The layout writes every request's permits into the first
                # ``count`` entries; the padding reads as 0.
                perms_rank = take(_bucket_fine(count) + u_b, np.uint8)
                perms_rank[count:] = 0
                weighted_layout(uwords, rb, uidx, rank, p_chunk, r_b,
                                uw_sorted, spos, roff, perms_rank)
                bufs = [uw_sorted, perms_rank]
                t1 = time.perf_counter()
                bits = rank_dispatch(uw_sorted, perms_rank, roff, lid,
                                     self._monotonic_now(), r_b)
                result = ("relay_w|weighted_native", [
                    (bits, lambda arr: weighted_decide(arr, roff, spos, uidx,
                                                       rank))])
                wire = 4 * u_b + len(perms_rank) + len(perms_rank) // 8
                dev_s = count * rates["s_per_lane"]
            else:
                rec["mode"] = "flat_fb"
                slots_req = uslots[uidx]
                bufs, parts = [], []
                t1 = time.perf_counter()
                now = self._monotonic_now()
                # One flat dispatch per _FLAT_MAX_LANES requests, each
                # fetched and recorded on its own, as the reference's.
                for o in range(0, count, _FLAT_MAX_LANES):
                    m = min(_FLAT_MAX_LANES, count - o)
                    s_lane = take(m, np.int32)
                    s_lane[:] = slots_req[o:o + m]
                    p_lane = take(m, np.uint8)
                    p_lane[:] = p_chunk[o:o + m]
                    bufs += [s_lane, p_lane]
                    parts.append((
                        flat_dispatch(s_lane, lid, p_lane, now),
                        lambda arr, m=m: np.unpackbits(arr)[:m].astype(bool)))
                result = ("relay_w|flat", parts)
                wire = 5 * count
                dev_s = count * rates["s_per_lane"]
            rec["layout_s"] = t1 - t0
            rec["enqueue_s"] = time.perf_counter() - t1
            rec["wire_bytes"] = int(wire)
            with tot["_lock"]:
                tot["wire"] += wire
                tot["chunks"] += 1
                tot["cu"].append((int(count), int(u)))
                tot["bpr"] = wire / max(count, 1)
                tot["device_s"] += dev_s
            if not pipelined:
                cursor.grow(int(min(max(_RELAY_WIRE_BUDGET_WEIGHTED * count
                                        / wire, _RELAY_CHUNK),
                                    _RELAY_CHUNK_MAX)))
            return result[0], lid, result[1], bufs

        out = self._run_chunks(algo, n, cursor,
                               self._assign_uniques(algo, walk), dispatch,
                               hash_times, tot, t_pass0, "relay_w")
        self._plan_finish(plan_key, pipelined, n, tot, t_pass0)
        return out

    def _stream_flat(self, algo: str, lid, n: int, walk,
                     permits: np.ndarray | None,
                     oversize: np.ndarray | None, batch: int,
                     subbatches: int, lid_arr: np.ndarray | None,
                     hash_times=None) -> np.ndarray:
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
        or ``scan``), the lanes' bytes (``wire_bytes``), and the layout,
        enqueue and drain times."""
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
        lane_bytes = 4 + (4 if lid_arr is not None else 0) + (
            np.dtype(p_dtype).itemsize if permits is not None else 0)
        # The reference names the route by the stream's K, not the
        # chunk's.
        path = "flat|scan" if k_scan else "flat|sorted"

        def assign(start: int, count: int):
            with self._evictions_cleared(algo):
                slots, clears = walk(start, count,
                                     self._batcher.pending_slots(algo))
            return slots, clears, slots

        def lanes(values, size, fill, dtype, bufs):
            arr = self._staging.take(size, dtype)
            arr[:len(values)] = values
            arr[len(values):] = fill
            bufs.append(arr)
            return arr

        def dispatch(start, count, slots, rec):
            # A tail super-batch scans only the steps it fills.
            k_i = min(k_scan, -(-count // _FLAT_MAX_LANES))
            size = k_i * _FLAT_MAX_LANES if k_i else count
            rec["mode"] = "scan" if k_i else "flat"
            rec["wire_bytes"] = size * lane_bytes
            t0 = time.perf_counter()
            bufs: list = []
            s_lane = lanes(slots, size, -1, np.int32, bufs)
            if oversize is not None:
                s_lane[:count][oversize[start:start + count]] = -1
            l_lane = lid if lid_arr is None else lanes(
                lid_arr[start:start + count], size, 0, np.int32, bufs)
            p_lane = None if permits is None else lanes(
                permits[start:start + count], size, 1, p_dtype, bufs)
            t1 = time.perf_counter()
            now = self._monotonic_now()
            if k_i:
                shape = (k_i, _FLAT_MAX_LANES)
                bits = scan_dispatch(
                    s_lane.reshape(shape),
                    l_lane if lid_arr is None else l_lane.reshape(shape),
                    None if p_lane is None else p_lane.reshape(shape),
                    lanes((), k_i, now, np.int64, bufs))
            else:
                bits = flat_dispatch(s_lane, l_lane, p_lane, now)
            rec["layout_s"] = t1 - t0
            rec["enqueue_s"] = time.perf_counter() - t1
            self._stage("enqueue", rec["enqueue_s"])
            return path, lid if lid_arr is None else None, [(
                bits, lambda arr: np.unpackbits(arr, axis=-1).reshape(-1)
                [:count].astype(bool))], bufs

        return self._run_chunks(algo, n,
                                _ChunkCursor({"chunk": super_n}, True),
                                assign, dispatch, hash_times)

    # ------------------------------------------------------------------------
    # The sharded engine's streams (parallel/sharded.py)
    # ------------------------------------------------------------------------
    def _stream_sharded(self, algo: str, lid, key_ids: np.ndarray,
                        permits, oversize, batch: int, subbatches: int,
                        index: ShardedSlotIndex,
                        lid_arr: np.ndarray | None) -> np.ndarray:
        """A sharded engine's int-key stream, as the reference's
        ``_stream_sharded``: unit permits under limits below the relay
        word's clamp go to the per-shard relay lanes
        (:meth:`_stream_relay_sharded`).  Everything else goes in
        super-batches: one host routing pass (splitmix64), the shards'
        C assigns on a pool, and one flat sorted step a shard
        (``*_flat_sharded_dispatch``) at the super-batch's timestamp.
        Each shard's result lands on its own stream (:meth:`_land`) and
        the super-batch's drain goes to a :class:`_DrainSet`, as the
        reference's does, so super-batch k+1 is routed and assigned while
        k's drain waits on its shards' events.  Decisions equal the flat storage's on the same per-key order
        (a key's requests all go to its shard, in arrival order)."""
        eng = self.engine
        if permits is None and eng.relay_usable():
            return self._stream_relay_sharded(algo, lid, key_ids, index,
                                              lid_arr)
        n_sh = eng.n_shards
        # The busiest shard's slice, bucketed to a power of two, stays at
        # or under the flat step's lane cap with hash imbalance: half the
        # one-device lanes a shard.
        super_n = min(int(subbatches) * int(batch),
                      (_FLAT_MAX_LANES // 2) * n_sh)
        dispatch = (eng.sw_flat_sharded_dispatch if algo == "sw"
                    else eng.tb_flat_sharded_dispatch)
        n = len(key_ids)
        out = np.empty(n, dtype=bool)
        chunks: List[dict] = []
        self.last_stream_chunks = chunks
        pool = self._shard_pool(n_sh)
        drains = _DrainSet(self._drain_pool())

        def drain(item, landings, bufs):
            handle, start, cn, shard, cols, width, t0, rec = item
            try:
                tf0 = time.perf_counter()
                for land in landings:
                    if land is not None:
                        land.wait()
                tf1 = time.perf_counter()
                nb = -(-width // 8)
                arr = np.zeros((n_sh, nb), dtype=np.uint8)
                for q, land in enumerate(landings):
                    if land is not None:
                        arr[q, :land.host.shape[-1]] = land.host.reshape(
                            -1)[:nb]
                got = np.unpackbits(arr, axis=1)[:, :width].astype(bool)[
                    shard, cols]
                out[start:start + cn] = got
                with self._drain_lock:
                    rec["drain_s"] = tf1 - tf0
                    self._stage("fetch", tf1 - tf0)
                    self._record_dispatch(
                        algo, cn, int(got.sum()), (tf1 - t0) * 1e6,
                        path="sharded|flat",
                        lid=None if lid_arr is not None else lid)
            finally:
                self._give_back([land for land in landings
                                 if land is not None], bufs, self._staging)

        try:
            for start in range(0, n, super_n):
                item, bufs = self._stream_sharded_chunk(
                    algo, lid, key_ids, permits, oversize, index, lid_arr,
                    start, super_n, pool, dispatch)
                chunks.append(item[-1])
                # Each shard's result lands on its own stream, behind its
                # step.
                landings = [None if t is None
                            else self._land(t, self._staging, q)
                            for q, t in enumerate(item[0])]
                drains.submit(drain, item, landings, bufs)
            drains.finish()
        finally:
            drains.finish(swallow=True)
        return out

    def _stream_sharded_chunk(self, algo, lid, key_ids, permits, oversize,
                              index, lid_arr, start, super_n, pool,
                              dispatch):
        """One super-batch of :meth:`_stream_sharded`: route, assign on
        every shard at once (pinned; evictions cleared before the
        dispatch, also those of shards that assigned when another
        failed), lay out the ``(n_shards, B)`` local-slot matrix with its
        lid and permit lanes, dispatch, release the pins.  Returns the
        drain's arguments, the chunk record last."""
        eng = self.engine
        n_sh, sps = eng.n_shards, eng.slots_per_shard
        t0 = time.perf_counter()
        chunk = key_ids[start:start + super_n]
        cn = len(chunk)
        pins = self._batcher.pending_slots_sharded(algo, sps)
        l_chunk = None if lid_arr is None else lid_arr[start:start + cn]
        # The host router, as the reference's flat chunks route (no
        # election).
        shard, order, counts, kst = self._route_host(chunk, None, None)
        offs = np.zeros(n_sh + 1, dtype=np.int64)
        np.cumsum(counts, out=offs[1:])
        l_st = None if l_chunk is None else l_chunk[order]
        t_route = time.perf_counter()
        self._stage("route", t_route - t0)

        def assign_shard(q):
            lo, hi = int(offs[q]), int(offs[q + 1])
            if lo == hi:
                return None
            sub = index._sub[q]
            if l_st is not None:
                return sub.assign_batch_ints_multi(
                    kst[lo:hi], l_st[lo:hi], pinned=pins.get(q),
                    hold_pins=True)
            return sub.assign_batch_ints(kst[lo:hi], lid,
                                         pinned=pins.get(q), hold_pins=True)

        local_sorted = np.empty(cn, dtype=np.int32)
        held: list = []
        clears: list = []
        try:
            futs = [pool.submit(assign_shard, q) for q in range(n_sh)]
            err = None
            for q, f in enumerate(futs):
                try:
                    r = f.result()
                except Exception as exc:  # noqa: BLE001 — re-raised below
                    err = err if err is not None else exc
                    clears.extend(consume_pending_clears(exc, q * sps))
                    continue
                if r is None:
                    continue
                sl, ev = r
                local_sorted[offs[q]:offs[q + 1]] = sl
                held.append(q * sps + np.asarray(sl, dtype=np.int64))
                clears.extend(q * sps + int(e) for e in ev)
            t_assign = time.perf_counter()
            self._stage("index", t_assign - t_route)
            # Shards that assigned before a failure remapped their keys:
            # their evictions are zeroed even though nothing dispatches.
            if clears:
                self._clear_slots(algo, clears)
            if err is not None:
                raise err
            local = np.empty(cn, dtype=np.int32)
            local[order] = local_sorted
            # Each request's column in its shard's row, in arrival order
            # (the stable per-slot order the flat step sorts by).
            cols = np.empty(cn, dtype=np.int64)
            cols[order] = np.arange(cn) - offs[shard[order]]
            width = _shard_bucket(int(counts.max(initial=1)))
            slots_mat = self._staging.take((n_sh, width), np.int32)
            slots_mat.fill(-1)
            slots_mat[shard, cols] = local
            bufs = [slots_mat]
            if oversize is not None:
                ov = oversize[start:start + cn]
                slots_mat[shard[ov], cols[ov]] = -1  # denied, untouched
            lid_sb = lid
            if l_chunk is not None:
                lid_sb = self._staging.take((n_sh, width), np.int32)
                lid_sb.fill(0)
                lid_sb[shard, cols] = l_chunk
                bufs.append(lid_sb)
            p_sb = None
            if permits is not None:
                p_sb = self._staging.take((n_sh, width), np.int32)
                p_sb.fill(1)
                p_sb[shard, cols] = permits[start:start + cn]
                bufs.append(p_sb)
            t_layout = time.perf_counter()
            self._stage("layout", t_layout - t_assign)
            handle = dispatch(slots_mat, lid_sb, p_sb, self._monotonic_now())
            t_enq = time.perf_counter()
            self._stage("enqueue", t_enq - t_layout)
        finally:
            self._unpin_held(index, held)
        rec = {"requests": cn, "mode": "flat", "shard_n": counts.tolist(),
               "route_s": t_route - t0, "assign_s": t_assign - t_route,
               "layout_s": t_layout - t_assign,
               "enqueue_s": t_enq - t_layout}
        return (handle, start, cn, shard, cols, width, t0, rec), bufs

    def _stream_relay_sharded(self, algo: str, lid, key_ids, index,
                              lid_arr: np.ndarray | None,
                              key_kind: str = "ints") -> np.ndarray:
        """A sharded engine's unit-permit stream over independent per-shard
        pipelines, as the reference's ``_stream_relay_sharded``.

        Per chunk the calling thread does one routing pass, on the host
        or the device as elected (:meth:`_route_sharded`; string keys are
        hashed first and routed by their fingerprint's h1) and hands each
        shard its slice; from
        there everything is the shard's own, on its lane
        (:class:`_ShardLane`): the C assign of its sub-index, its eviction
        clears (``ShardedDeviceEngine.clear_shard``), its mode, layout and
        dispatch (``relay_shard_dispatch``, on its device and stream), and
        its drain.  No barrier spans shards; each lane is a FIFO, which
        orders a shard's clears before the dispatch that reuses the
        slots.  A shard's mode is elected from its own uniques, as the
        reference elects it: the digest when ``digest_bpu * bucket(u) <=
        words_bpr * n`` and the counts fit a dtype (one limiter: the relay
        step kernel; a lid array: a lid per unique), else words mode.
        Chunks grow from ``_RELAY_CHUNK`` toward the wire budget of the
        modes the shards took, and the learned size starts the next call
        of the same shape.

        Each chunk's record in ``last_stream_chunks``: requests, uniques,
        ``modes`` and ``shard_n`` per shard, ``wire_bytes``,
        ``shard_fetch_s`` (each lane's event wait) and ``shard_drain_s``
        (its wait and decode), the routing (``route_s``, and ``pack_s``
        for strings) and the slowest shard's assign.  Decisions
        equal the flat storage's on the same per-key order."""
        eng = self.engine
        n_sh, sps = eng.n_shards, eng.slots_per_shard
        rb = eng.rank_bits
        cdt = eng.counts_dtype()
        multi = lid_arr is not None
        digest_bpu, words_bpr = wire_costs(multi, lid_lane=True)
        n = len(key_ids)
        out = np.empty(n, dtype=bool)
        chunks: List[dict] = []
        self.last_stream_chunks = chunks
        if n == 0:
            return out
        lanes = self._shard_lanes(n_sh)
        stop = threading.Event()
        errors: list = []  # (chunk, shard, exc): the first in stream order
        err_lock = threading.Lock()

        def fail(ci, q, exc):
            with err_lock:
                errors.append((ci, q, exc))
            stop.set()

        def shard_task(ci, q, start, now, keys_q, h1_q, h2_q, pos_q, l_q,
                       pins_q, ctx):
            """One shard's work for one chunk, on its lane.  Never
            raises: a failure lands in ``errors`` and stops the other
            lanes' dispatches (evictions already applied are cleared)."""
            if stop.is_set():
                return
            lane = lanes[q]
            sub = index._sub[q]
            ns = len(pos_q)
            pinned_local = None
            bufs: list = []  # the staging buffers the dispatch reads
            try:
                tw0 = time.perf_counter()
                try:
                    if key_kind != "ints":
                        uw, uidx, rank, ev = sub.assign_batch_fps_uniques(
                            h1_q, h2_q, rb, pinned=pins_q, hold_pins=True)
                    elif multi:
                        uw, uidx, rank, ev = (
                            sub.assign_batch_ints_multi_uniques(
                                keys_q, l_q, rb, pinned=pins_q,
                                hold_pins=True))
                    else:
                        uw, uidx, rank, ev = sub.assign_batch_ints_uniques(
                            keys_q, lid, rb, pinned=pins_q, hold_pins=True)
                except Exception as exc:  # noqa: BLE001 — re-raised
                    pc = consume_pending_clears(exc, 0)
                    if len(pc):
                        self._clear_shard(algo, q, pc)
                    raise
                walk_s = time.perf_counter() - tw0
                ctx["walk"][q] = walk_s
                self._stage("index", walk_s)
                pinned_local = (uw >> np.uint32(rb + 1)).astype(np.int32)
                if len(ev):
                    self._clear_shard(algo, q, ev)
                u = len(uw)
                ctx["u"][q] = u
                t_l0 = time.perf_counter()
                digest = (cdt is not None and digest_bpu
                          * _shard_bucket(max(u, 1)) <= words_bpr * ns)
                take = lane.staging.take
                lid_lane = lid
                if digest:
                    if u >= _SORT_UNIQUES_MIN:
                        sort_uniques(uw, rb, uidx)
                    buf = take(_shard_bucket(max(u, 1)), np.uint32)
                    buf[:u] = uw
                    buf[u:] = 0xFFFFFFFF
                    bufs.append(buf)
                    if multi:
                        first = rank == 0
                        lid_lane = take(len(buf), np.int32)
                        lid_lane.fill(0)
                        lid_lane[uidx[first]] = l_q[first]
                        bufs.append(lid_lane)
                    ctx["wire"][q] = digest_bpu * u
                else:
                    buf = take(_shard_bucket(max(ns, 1)), np.uint32)
                    rebuild_words_into(uw, uidx, rank, rb, buf[:ns])
                    buf[ns:] = 0xFFFFFFFF
                    bufs.append(buf)
                    if multi:
                        lid_lane = take(len(buf), np.int32)
                        lid_lane[:ns] = l_q
                        lid_lane[ns:] = 0
                        bufs.append(lid_lane)
                    ctx["wire"][q] = words_bpr * ns
                mode = "digest" if digest else "words"
                ctx["modes"][q] = mode
                ctx["layout"][q] = time.perf_counter() - t_l0
                self._stage("layout", ctx["layout"][q])
                if stop.is_set():  # another shard failed after our assign
                    return
                t0 = time.perf_counter()
                handle = eng.relay_shard_dispatch(
                    algo, q, "counts" if digest else "bits", buf, lid_lane,
                    now, cdt if digest else None)
                # The result lands on the shard's stream, behind its step.
                landing = self._land(handle[:u] if digest else handle,
                                     lane.staging, q)
                ctx["enq"][q] = time.perf_counter() - t0
                self._stage("enqueue", ctx["enq"][q])
            except Exception as exc:  # noqa: BLE001 — reported to the caller
                fail(ci, q, exc)
                return
            finally:
                # Pins release once the dispatch is on the shard's stream
                # (or on any failure).
                if pinned_local is not None:
                    sub.unpin_batch(pinned_local)

            def drain():
                try:
                    tf0 = time.perf_counter()
                    landing.wait()
                    tf1 = time.perf_counter()
                    if mode == "digest":
                        got = relay_decide(landing.host, uidx, rank)
                    else:
                        got = np.unpackbits(landing.host)[:ns].astype(bool)
                    out[start + pos_q] = got
                    ctx["fetch"][q] = tf1 - tf0
                    ctx["drain"][q] = time.perf_counter() - tf0
                    with self._drain_lock:
                        self._stage("fetch", tf1 - tf0)
                        self._record_dispatch(algo, ns, int(got.sum()),
                                              (tf1 - t0) * 1e6,
                                              path=f"sharded|{mode}",
                                              shard=q,
                                              lid=None if multi else lid)
                finally:
                    self._give_back([landing], bufs, lane.staging)

            lane.drains.submit(drain)

        # The learned chunk size of this stream shape, the reference's
        # giant plan record; the sharded lanes run no election.
        plan_key = ("relay_sharded", key_kind, algo, multi,
                    _bucket_fine(n, floor=_RELAY_CHUNK))
        plan = self._chunk_plans.get(plan_key)
        chunk = (int(plan["chunk"]) if plan and plan.get("chunk")
                 else _RELAY_CHUNK)
        inflight: list = []
        ci = 0
        start = 0

        def finalize(ctx):
            """Join a chunk's shard tasks, fill its record and learn the
            next chunk's size from the bytes a request it shipped."""
            nonlocal chunk
            for f in ctx["futs"]:
                f.result()  # the tasks never raise; executor faults do
            rec = ctx["rec"]
            wire = float(ctx["wire"].sum())
            modes = [m for m in ctx["modes"] if m]
            rec.update(uniques=int(ctx["u"].sum()), modes=ctx["modes"],
                       mode=(modes[0] if len(set(modes)) == 1 else "mixed"),
                       wire_bytes=int(wire),
                       assign_s=float(ctx["walk"].max()),
                       shard_assign_s=ctx["walk"].tolist(),
                       layout_s=float(ctx["layout"].sum()),
                       enqueue_s=float(ctx["enq"].sum()),
                       shard_fetch_s=ctx["fetch"],
                       shard_drain_s=ctx["drain"])
            if wire > 0 and ctx["cn"]:
                bpr = max(wire / ctx["cn"], 1e-3)
                digests = sum(1 for m in modes if m == "digest")
                budget = (_RELAY_WIRE_BUDGET_DIGEST
                          if 2 * digests >= max(len(modes), 1)
                          else _RELAY_WIRE_BUDGET_WORDS)
                chunk = int(min(max(budget / bpr, _RELAY_CHUNK),
                                _RELAY_CHUNK_MAX))

        try:
            while start < n and not stop.is_set():
                cn = min(chunk, n - start)
                t_r0 = time.perf_counter()
                pack_s = 0.0
                kst = h1st = h2st = None
                if key_kind == "ints":
                    shard, order, counts, kst = self._route_sharded(
                        kchunk=key_ids[start:start + cn])
                else:
                    h1, h2 = hash_str_keys(key_ids, lid, start, cn)
                    pack_s = time.perf_counter() - t_r0
                    self._stage("pack", pack_s)
                    shard, order, counts, h1st, h2st = self._route_sharded(
                        h1=h1, h2=h2)
                route_s = time.perf_counter() - t_r0 - pack_s
                self._stage("route", route_s)
                offs = np.zeros(n_sh + 1, dtype=np.int64)
                np.cumsum(counts, out=offs[1:])
                l_chunk = lid_arr[start:start + cn] if multi else None
                pins = self._batcher.pending_slots_sharded(algo, sps)
                now = self._monotonic_now()
                rec = {"requests": int(cn), "shard_n": counts.tolist(),
                       "route_s": route_s}
                if key_kind != "ints":
                    rec["pack_s"] = pack_s
                chunks.append(rec)
                ctx = {"cn": cn, "rec": rec, "walk": np.zeros(n_sh),
                       "layout": np.zeros(n_sh), "enq": np.zeros(n_sh),
                       "wire": np.zeros(n_sh), "u": np.zeros(n_sh, np.int64),
                       "modes": [None] * n_sh, "drain": [0.0] * n_sh,
                       "fetch": [0.0] * n_sh, "futs": []}
                for q in range(n_sh):
                    lo, hi = int(offs[q]), int(offs[q + 1])
                    if lo == hi:
                        continue
                    pos_q = order[lo:hi]
                    ctx["futs"].append(lanes[q].pipe.submit(
                        shard_task, ci, q, start, now,
                        None if kst is None else kst[lo:hi],
                        None if h1st is None else h1st[lo:hi],
                        None if h2st is None else h2st[lo:hi],
                        pos_q, None if l_chunk is None else l_chunk[pos_q],
                        pins.get(q), ctx))
                inflight.append(ctx)
                start += cn
                ci += 1
                # Route at most _SHARD_LOOKAHEAD chunks past the oldest one
                # still assembling (bounds the host buffers and the lag of
                # the learned chunk size).
                while len(inflight) > _SHARD_LOOKAHEAD:
                    finalize(inflight.pop(0))
            while inflight:
                finalize(inflight.pop(0))
            if not stop.is_set():
                for lane in lanes:
                    lane.drains.finish()
        finally:
            while inflight:
                try:
                    finalize(inflight.pop(0))
                except Exception:  # noqa: BLE001 — the first error wins
                    pass
            for lane in lanes:
                lane.drains.finish(swallow=True)
        if errors:
            errors.sort(key=lambda e: (e[0], e[1]))
            raise errors[0][2]
        if self.stream_stats is not None:
            self._chunk_stats("relay_sharded", chunks)
        self._chunk_plans[plan_key] = {"kind": "giant", "chunk": chunk,
                                       "passes": 3}
        return out

    def _route_sharded(self, kchunk=None, h1=None, h2=None):
        """One chunk's shard routing: ``(shard, order, counts,
        keys_sorted)`` for int keys, ``(shard, order, counts, h1_sorted,
        h2_sorted)`` for fingerprints.  The host C router
        (``rl_shard_route2`` / ``rl_route_hashes2``, the gather fused in)
        or the engine's device route
        (``ShardedDeviceEngine.route_on_device``, the gather after it),
        elected as the reference elects them: ``RATELIMITER_DEVICE_ROUTE``
        ``on`` / ``off`` fixes the route at the first chunk; under
        ``auto`` (the default) a chunk below ``_ROUTE_ELECT_MIN``
        requests takes the host router without deciding, and the first
        chunk at or above it times the host router, warms the device
        route once, then times it with the gather, keeps the faster for
        the storage's life and records ``sharded.route_elect`` (``host_s``,
        ``device_s``, ``elected``, ``n``) to the flight recorder.  On a
        card the device route returns through ``.cpu()``, so its time
        holds the wait for the card.  Both routes bin alike (tests hold
        them equal)."""
        eng = self.engine
        ints = h1 is None
        n = len(kchunk) if ints else len(h1)

        def device():
            return (eng.route_on_device(key_ids=kchunk) if ints
                    else eng.route_on_device(hashes=h1))

        mode = self._route_mode
        if mode is None:
            env = os.environ.get("RATELIMITER_DEVICE_ROUTE", "auto").lower()
            if env in ("1", "on", "device"):
                mode = self._route_mode = "device"
            elif env in ("0", "off", "host"):
                mode = self._route_mode = "host"
            elif n < _ROUTE_ELECT_MIN:
                mode = "host"  # too small to measure; not sticky
            else:
                t0 = time.perf_counter()
                host = self._route_host(kchunk, h1, h2)
                host_s = time.perf_counter() - t0
                device()  # the first call's allocations stay out
                t0 = time.perf_counter()
                dev = device()
                _ = kchunk[dev[1]] if ints else h1[dev[1]]
                dev_s = time.perf_counter() - t0
                self._route_mode = "device" if dev_s < host_s else "host"
                if self._recorder is not None:
                    self._recorder.record(
                        "sharded.route_elect", host_s=round(host_s, 6),
                        device_s=round(dev_s, 6), elected=self._route_mode,
                        n=int(n))
                return host
        if mode == "device":
            shard, order, counts = device()
            if ints:
                return shard, order, counts, kchunk[order]
            return shard, order, counts, h1[order], h2[order]
        return self._route_host(kchunk, h1, h2)

    def _route_host(self, kchunk, h1, h2):
        n_sh = self.engine.n_shards
        if h1 is None:
            return shard_route_gather(kchunk, n_sh)
        return route_hashes_gather(h1, h2, n_sh)

    def _clear_shard(self, algo: str, q: int, local_slots) -> None:
        """Zero evicted LOCAL slots of shard ``q`` on its stream (the
        sharded relay lanes' clears); the hybrid tier forgets them, as
        :meth:`_clear_slots` has it forget what it clears."""
        local = np.asarray(local_slots, dtype=np.int64)
        if not len(local):
            return
        if self._serving is not None:
            self._serving.invalidate_slots(
                algo, (local + q * self.engine.slots_per_shard).tolist())
        self.engine.clear_shard(algo, q, local)

    def _shard_lanes(self, n_sh: int) -> List[_ShardLane]:
        """The sharded relay stream's lanes (:class:`_ShardLane`), made at
        first use, each recording its saturation to the storage's flight
        recorder, as the reference's (``storage/tpu.py:3100``)."""
        lanes = self._shard_lanes_obj
        if lanes is None:
            lanes = self._shard_lanes_obj = [
                _ShardLane(q, recorder=self._recorder,
                           pinned=self.device.type == "cuda")
                for q in range(n_sh)]
        return lanes

    def _assign_pool(self):
        """The one worker that prefetches the next chunk's assign while
        the calling thread waits (the reference's; the C walk releases
        the GIL), made at first use."""
        pool = self._assign_pool_obj
        if pool is None:
            import concurrent.futures as cf

            pool = self._assign_pool_obj = cf.ThreadPoolExecutor(
                1, thread_name_prefix="assignpf")
        return pool

    def _drain_pool(self):
        """The ``_DRAIN_WORKERS`` drain workers of the flat stream loops,
        made at first use.  A drain sleeps in its event's wait (which
        releases the GIL), so they cost no CPU beyond their decodes."""
        pool = self._drain_pool_obj
        if pool is None:
            import concurrent.futures as cf

            pool = self._drain_pool_obj = cf.ThreadPoolExecutor(
                _DRAIN_WORKERS, thread_name_prefix="drain")
        return pool

    def _abort_prefetch(self, algo: str, index, fut, slots_of) -> None:
        """Consume an orphaned prefetched assign (an exception left the
        loop before it took it), as the reference's: the index already
        applied it, so its evictions (the result's last element) map to
        new keys and are cleared on the card before any reuse, and its
        pins (``slots_of(result)``) are released.  A prefetch that itself
        failed holds nothing (its evictions were cleared where it
        raised)."""
        try:
            res = fut.result()
        except Exception:  # noqa: BLE001 — a failed assign holds nothing
            return
        try:
            clears = res[-1]
            if len(clears):
                self._clear_slots(algo, list(clears))
        finally:
            slots = slots_of(res)
            if slots is not None and len(slots):
                self._unpin_held(index, [slots])

    @staticmethod
    def _unpin_held(index, held) -> None:
        """Release pins gathered as a list of slot arrays (the reference's):
        the ``finally`` of a loop that pins part by part."""
        if held:
            index.unpin_batch(np.concatenate(held))

    def _shard_pool(self, n_sh: int):
        """The pool of the sharded flat stream's per-shard assigns, as
        many threads as shards or usable cores, whichever is fewer (the C
        walks release the GIL)."""
        pool = self._shard_pool_obj
        if pool is None:
            import concurrent.futures as cf

            try:
                cores = len(os.sched_getaffinity(0))
            except (AttributeError, OSError):  # not Linux
                cores = os.cpu_count() or 1
            pool = self._shard_pool_obj = cf.ThreadPoolExecutor(
                max(1, min(n_sh, cores)), thread_name_prefix="shardidx")
        return pool

    # ------------------------------------------------------------------------
    # The link profile and the chunk plans (the reference's link-adaptive
    # planning)
    # ------------------------------------------------------------------------
    def set_link_profile(self, upload_bytes_per_s: float, rtt_s: float,
                         download_bytes_per_s: float | None = None) -> None:
        """Set what the host <-> device link measures; the stream loops
        elect their chunk plans, modes, sort and split under it.  The
        download rate defaults to the upload rate.  Every chunk plan is
        dropped: it was elected for the old link."""
        self._link_profile = (float(upload_bytes_per_s), float(rtt_s),
                              float(download_bytes_per_s
                                    if download_bytes_per_s is not None
                                    else upload_bytes_per_s))
        self._chunk_plans.clear()

    def probe_link(self) -> Tuple[float, float, float]:
        """Measure the link to the storage's device (``utils/link.py``) and
        set it as the profile; returns the profile.  A failing probe
        raises."""
        from ratelimiter_tpu_torch.utils.link import measure_link

        up_bps, rtt_s, down_bps = measure_link(self.engine.device)
        self.set_link_profile(up_bps, rtt_s, down_bps)
        return self._link_profile

    def _device_rates(self) -> dict:
        """The device step rates the elections charge: the fallback
        constants without a profile (no election reads them then), else
        the rates of the storage's device (``engine/device_rates.py``),
        probed once."""
        if self._link_profile is None:
            return _FB_RATES
        if self._device_rates_obj is None:
            self._device_rates_obj = get_device_rates(self.engine.device)
        return self._device_rates_obj

    def _elect_chunk_plan(self, key: tuple, n: int, tot: dict,
                          wall_s: float) -> None:
        """After a giant pass of stream shape ``key`` (``n`` requests,
        measured totals ``tot``, wall ``wall_s``): keep the growth chunks
        or move later passes to a fixed schedule, as the reference elects
        (``storage/tpu.py:_elect_chunk_plan``).

        Nothing is elected without a profile, for a stream under 4 *
        ``_RELAY_CHUNK`` requests, or past a plan that is pipelined,
        locked or giant after three passes.  A shape's first pass records
        a provisional giant plan (its walk inserts and its first launches
        build).  A later one fits the dedup curve u = A * c^alpha to the
        chunks' (requests, uniques), ranks :func:`_schedule_candidates`
        with :func:`_sim_schedule_wall` against the giant schedule's
        simulated wall, and elects the best one below
        ``_PIPELINE_WIN_MARGIN`` of it.  The cache holds 128 plans; past
        that, giant and provisional plans go first, then pipelined ones,
        then locked ones."""
        cur = self._chunk_plans.get(key)
        if cur is not None and (cur["kind"] != "giant" or cur.get("locked")
                                or cur.get("passes", 0) >= 3):
            return
        if self._link_profile is None:
            return
        if n < (_RELAY_CHUNK << 2) or tot["walk_s"] <= 0:
            return
        prof = self._link_profile
        up, rtt = prof[0], prof[1]
        down = prof[2] if len(prof) > 2 else up
        chunks = max(tot.get("chunks", 1), 1)
        wire_s = tot["wire"] / max(up, 1.0)
        serial_pred = (tot["walk_s"] + tot.get("host_s", 0.0) + wire_s
                       + tot.get("device_s", 0.0) + chunks * rtt)
        if cur is None:
            if len(self._chunk_plans) >= 128:
                self._chunk_plans = {k: v for k, v
                                     in self._chunk_plans.items()
                                     if v.get("locked")
                                     or v["kind"] == "pipelined"}
                if len(self._chunk_plans) >= 128:
                    self._chunk_plans = {k: v for k, v
                                         in self._chunk_plans.items()
                                         if v.get("locked")}
                if len(self._chunk_plans) >= 128:
                    self._chunk_plans.clear()
            self._chunk_plans[key] = {"kind": "giant", "chunk": 0,
                                      "ref": round(serial_pred, 4),
                                      "passes": 1}
            return
        digest_frac = tot.get("digest_chunks", 0) / chunks
        cu = [p for p in tot.get("cu", []) if p[0] > 0 and p[1] > 0]
        alpha, a_fit = 1.0, 1.0
        if len(cu) >= 2:
            (c1, u1) = cu[0]
            (c2, u2) = max(cu, key=lambda p: p[0])
            if c2 > c1 * 1.5:
                alpha = min(max(math.log(max(u2, 1) / max(u1, 1))
                                / math.log(c2 / c1), 0.55), 1.0)
            a_fit = u2 / (c2 ** alpha)
        elif cu:
            a_fit = cu[0][1] / float(cu[0][0])
        rates = self._device_rates()
        bpu_up = 8.0 if tot.get("bpu", 6.0) >= 10.0 else 4.0
        bpu_down = 2.0 if tot.get("bpu", 6.0) >= 10.0 else 1.0
        dev_lane = rates["s_per_unique_unsorted" if digest_frac > 0.5
                         else "s_per_lane"]
        if key[0] == "weighted" and cu:
            # The weighted wire per unique: the 4 B word plus ~1.125 B a
            # request of permits and bits, through the pass's requests a
            # unique; the device's scan per request, likewise.
            r_pu = max(cu[-1][0] / max(cu[-1][1], 1), 1.0)
            digest_frac = 1.0
            bpu_up = 4.0 + 1.125 * r_pu
            bpu_down = 0.125 * r_pu
            dev_lane = rates["s_per_lane"] * r_pu
        sim_args = dict(
            cpu_per_req=(tot["walk_s"] + tot.get("host_s", 0.0)) / n,
            digest_frac=digest_frac, dedup_a=a_fit, dedup_alpha=alpha,
            bpu_up=bpu_up, bpu_down=bpu_down,
            words_up=tot.get("bpr", 4.125) - 0.125,
            link_up=max(up * _DISPATCH_RATE_DERATE, 1.0),
            link_down=max(down * _DISPATCH_RATE_DERATE, 1.0), rtt=rtt,
            dev_per_lane=dev_lane)
        giant_sim = _sim_schedule_wall([_RELAY_CHUNK, n - _RELAY_CHUNK],
                                       **sim_args)
        best = None
        for sizes in _schedule_candidates(n, _RELAY_CHUNK,
                                          words_pow2=digest_frac <= 0.5):
            w = _sim_schedule_wall(sizes, **sim_args)
            if best is None or w < best[0]:
                best = (w, sizes)
        if best is not None and best[0] < _PIPELINE_WIN_MARGIN * giant_sim:
            # ref: the simulated serial baseline; giant_wall: the measured
            # wall of the giant pass, which the revert check reads.
            self._chunk_plans[key] = {"kind": "pipelined",
                                      "schedule": tuple(best[1]),
                                      "chunk": int(max(best[1])),
                                      "ref": round(serial_pred, 4),
                                      "giant_wall": round(wall_s, 4),
                                      "passes": 0, "best": None}
        else:
            self._chunk_plans[key] = {
                "kind": "giant", "chunk": 0, "ref": round(serial_pred, 4),
                "passes": cur.get("passes", 0) + 1}

    def _plan_setup(self, plan_key: tuple):
        """The head of the relay and weighted loops: ``(plan, pipelined,
        tot, cursor, t_pass0)``, the shape's plan, whether it runs a fixed
        schedule, the pass's totals (filled by :meth:`_run_chunks` and the
        dispatches, under ``tot["_lock"]``), its :class:`_ChunkCursor` and
        its start."""
        plan = self._chunk_plans.get(plan_key)
        pipelined = plan is not None and plan["kind"] == "pipelined"
        tot = {"walk_s": 0.0, "wire": 0.0, "fetch_s": 0.0, "chunks": 0,
               "device_s": 0.0, "digest_chunks": 0, "host_s": 0.0,
               "cu": [], "_lock": threading.Lock()}
        return (plan, pipelined, tot, _ChunkCursor(plan, pipelined),
                time.perf_counter())

    def _plan_finish(self, plan_key: tuple, pipelined: bool, n: int,
                     tot: dict, t_pass0: float) -> None:
        """The tail: a giant pass (re-)elects, a pipelined pass feeds the
        revert check."""
        wall_s = time.perf_counter() - t_pass0
        if pipelined:
            self._maybe_revert_plan(plan_key, wall_s)
        else:
            self._elect_chunk_plan(plan_key, n, tot, wall_s)

    def _maybe_revert_plan(self, key: tuple, wall_s: float) -> None:
        """A pipelined plan whose best pass (over at least two: the first
        builds the new shapes) stays above ``_PIPELINE_REVERT`` times the
        measured wall of the giant pass that elected it reverts to giant,
        locked, so the shapes cannot oscillate."""
        plan = self._chunk_plans.get(key)
        if plan is None or plan["kind"] != "pipelined":
            return
        plan["passes"] += 1
        plan["best"] = (wall_s if plan["best"] is None
                        else min(plan["best"], wall_s))
        ref = plan.get("giant_wall", plan["ref"])
        if plan["passes"] >= 2 and plan["best"] > _PIPELINE_REVERT * ref:
            self._chunk_plans[key] = {"kind": "giant", "chunk": 0,
                                      "ref": plan["ref"], "locked": True}

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
        for lane in self._shard_lanes_obj or ():
            lane.close()
        for pool in (self._shard_pool_obj, self._assign_pool_obj,
                     self._drain_pool_obj):
            if pool is not None:
                pool.shutdown(wait=False)

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
                         lid=None, shard: int = 0) -> None:
        """Latency timer, decision trace and the flight recorder's
        slow-dispatch anomaly for one drained dispatch; ``path`` names
        its route (micro, relay|digest, relay|bits, relay_w|...,
        flat|sorted, flat|scan, sharded|digest, sharded|words,
        sharded|flat), ``shard`` the shard a sharded lane ran on.  ``lid`` (a one-tenant dispatch's
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
                lin.record(tid, "shard", path=path, shard=shard, algo=algo,
                           batch=n, device_us=round(dt_us, 1))
                extra["trace"] = trace_hex(tid)
        self.trace.record(algo, n, allowed, dt_us, path=path, **extra)
        rec = self._recorder
        if rec.slo_us > 0.0 and dt_us > rec.slo_us:
            rec.anomaly("slow_dispatch", dt_us, algo=algo, batch=n,
                        path=path)

    def _stream_rec(self, path: str, **fields):
        """One per-chunk record appended to ``stream_stats`` (None = off)
        and returned, as the reference's: ``{"path": path, **fields}``,
        floats rounded to microseconds, fields given as None left out."""
        if self.stream_stats is None:
            return None
        rec = {"path": path}
        for k, v in fields.items():
            if v is not None:
                rec[k] = round(v, 6) if isinstance(v, float) else v
        self.stream_stats.append(rec)
        return rec

    def _chunk_stats(self, path: str, chunks: List[dict]) -> None:
        """A finished pass's ``last_stream_chunks`` as ``stream_stats``
        records (:meth:`_stream_rec`), one a chunk in stream order, with
        the fields the reference's loop ``path`` sets, from the port's
        timings:

        - every path: ``n`` (requests), ``assign_s`` (the chunk's
          assign wherever it ran), ``wire_bytes``, ``host_s``,
          ``fetch_s`` (the drain's event waits) and, but for ``flat``,
          ``u`` (uniques) and ``mode``;
        - but for ``relay_sharded``, the port's own
          :data:`PORT_CHUNK_FIELDS`: ``assign_wait_s`` (the calling
          thread's wait for the chunk's assign, exposed), and of string
          keys on any index ``hash_s`` (the hashing inside ``assign_s``)
          and ``key_pack_s`` (the slice and packing inside ``hash_s``);
        - ``relay`` and ``relay_w``: ``walk_s`` (the pass's assign
          seconds so far), ``fetch_at``; ``relay`` also ``dispatch_s``
          (layout and enqueue; a words chunk's enqueue alone, its layout
          as ``rebuild_s``), ``singles`` of a split chunk,
          ``host_parallel`` under partitions and, on one index, the
          string hashing as ``pack_s``.  Its modes take the reference's
          names: ``digest`` (the port's ``relay`` and ``resident``),
          ``bits`` (``words``), ``split``;
        - ``flat``: ``mode`` ``flat`` or ``scan``;
        - ``relay_sharded``: ``route_s``, ``shard_walk_s``, ``shard_n``,
          ``layout_s``, ``dispatch_s`` (the shards' enqueues),
          ``host_s`` (routing, layouts and enqueues), ``pack_s`` of
          string keys, and the slowest shard's wait as ``fetch_s``."""
        walk = 0.0
        for c in chunks:
            if path == "flat":
                fields = dict(mode=c["mode"], n=c["requests"],
                              assign_s=c["assign_s"],
                              wire_bytes=c["wire_bytes"], host_s=c["host_s"],
                              fetch_s=c["fetch_s"])
            elif path == "relay_sharded":
                fields = dict(
                    n=c["requests"], u=c["uniques"], mode=c["mode"],
                    wire_bytes=c["wire_bytes"], route_s=c["route_s"],
                    assign_s=c["assign_s"],
                    shard_walk_s=[round(x, 6) for x in c["shard_assign_s"]],
                    shard_n=c["shard_n"], layout_s=c["layout_s"],
                    dispatch_s=c["enqueue_s"],
                    host_s=c["route_s"] + c["layout_s"] + c["enqueue_s"],
                    pack_s=c.get("pack_s") or None,
                    fetch_s=max(c["shard_fetch_s"]))
            else:
                walk += c["assign_s"]
                fields = dict(n=c["requests"], u=c["uniques"],
                              assign_s=c["assign_s"], mode=c["mode"],
                              wire_bytes=c["wire_bytes"], walk_s=walk,
                              host_s=c["host_s"], fetch_s=c["fetch_s"],
                              fetch_at=[round(x, 6) for x in c["fetch_at"]])
                if path == "relay":
                    words = c["mode"] == "words"
                    fields.update(
                        mode=_REF_RELAY_MODES[c["mode"]],
                        rebuild_s=c["layout_s"] if words else None,
                        dispatch_s=c["enqueue_s"] + (
                            0.0 if words else c["layout_s"]),
                        singles=c.get("singles"),
                        host_parallel=self._host_parallel or None,
                        pack_s=(None if self._host_parallel
                                else c.get("pack_s")))
            if path != "relay_sharded":
                fields.update(assign_wait_s=c["assign_wait_s"],
                              hash_s=c.get("hash_s"),
                              key_pack_s=c.get("key_pack_s"))
            self._stream_rec(path, **fields)

    def _stage(self, stage: str, secs: float) -> None:
        """Record one chunk's seconds in a stream stage timer (no-op with
        observability off)."""
        t = self._stage_timers
        if t is not None:
            t[stage].record_us(secs * 1e6)

    def _land(self, handle: torch.Tensor, pool: _StagingPool,
              shard: int | None = None) -> _Landing:
        """Send a dispatched result home, right behind its step: on a card
        a copy into a page-locked buffer of ``pool`` and a CUDA event after
        it, on the stream the step ran on (shard ``shard``'s for a sharded
        engine; ``ops/transfer.py:land``); on the CPU the result's own
        array (the step has run)."""
        if handle.device.type != "cuda":
            return _Landing(handle.numpy())
        host = pool.take(tuple(handle.shape), _HOST_DTYPES[handle.dtype])
        event = (transfer.land(handle, host) if shard is None
                 else self.engine.land(shard, handle, host))
        return _Landing(host, event, pool)

    @staticmethod
    def _give_back(landings: list, bufs: list, pool: _StagingPool) -> None:
        """Return a chunk's landing buffers and the staging buffers its
        uploads read to ``pool``, once every landing's event has completed
        (a drain that failed early waits here): the uploads ran before the
        results' copies, so the last event covers them.  A failed wait
        returns nothing, so no buffer a copy may still touch is reused."""
        try:
            for land in landings:
                land.wait()
        except RuntimeError:
            return
        for land in landings:
            land.release()
        last = landings[-1].event if landings else None
        for buf in bufs:
            pool.give(buf, last)

    def _fetch(self, algo: str, path: str, t0: float, land: _Landing,
               decode, lid=None, waits: list | None = None) -> np.ndarray:
        """One landed result's drain, on a drain worker: wait for its
        event only (:meth:`_Landing.wait`; nothing to wait for on the
        CPU), ``decode`` the host array into decisions, and record the
        fetch stage and the dispatch under the drain lock (``t0``: the
        chunk's start; ``lid``: its one limiter, None for a lid array).
        The wait's window goes into ``waits``."""
        tf0 = time.perf_counter()
        land.wait()
        tf1 = time.perf_counter()
        if waits is not None:
            waits.append((tf0, tf1))
        got = decode(land.host)
        with self._drain_lock:
            self._stage("fetch", tf1 - tf0)
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
