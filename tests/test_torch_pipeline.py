"""The stream loops' pipeline against the JAX package's, on the CPU.

- ``_DrainSet`` (error propagation, ``finish(swallow=True)``,
  backpressure and its ``on_block`` hook) and ``_StagingPool`` (shape and
  dtype keys, the byte budget) run the same script on both packages.
- The prefetched assign: ``tests/test_chaos.py``'s stream whose second
  dispatch fails, and a drain that fails while the next chunk's assign is
  prefetched (``_DRAIN_INFLIGHT`` 0 on both packages, so the failing
  drain surfaces in the submit and ``_abort_prefetch`` consumes the
  prefetch), on a port storage and a reference storage side by side:
  the same recovery decisions, no pin left on either.
- A forced pipelined plan with the first chunk's drain held back until
  a later one has landed: decisions and both state
  tables equal to the reference's, for the relay, the weighted relay and
  the flat scan, at ``host_parallel`` 0 and 4 on both sides.
- ``close()`` stops the prefetch and drain workers.
- ROADMAP C18: a shard lane whose drains are held past
  ``_SHARD_DRAIN_INFLIGHT`` records ``shard.drain_saturated`` to the
  flight recorder, as the reference's lane does; a storage's lanes record
  to its own recorder.

On a card the buffers are page-locked and each drain waits on its chunk's
CUDA event; ``chip_smoke.py`` phase 22 checks that there.
"""

import concurrent.futures as cf
import threading
import time

import numpy as np
import pytest
import torch

from ratelimiter_tpu.core.config import RateLimitConfig as RefConfig
from ratelimiter_tpu.engine import native_index as ref_native
from ratelimiter_tpu.observability.flightrecorder import (
    FlightRecorder as RefRecorder,
)
from ratelimiter_tpu.storage import tpu as ref_mod
from ratelimiter_tpu.storage.tpu import TpuBatchedStorage
from ratelimiter_tpu_torch import RateLimitConfig
from ratelimiter_tpu_torch.engine.state import LimiterTable
from ratelimiter_tpu_torch.observability.flightrecorder import FlightRecorder
from ratelimiter_tpu_torch.parallel import ShardedDeviceEngine
from ratelimiter_tpu_torch.storage import gpu as gpu_mod
from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage
from torch_reference_native import (  # noqa: F401 (autouse fixture)
    idle_reference_flushers,
    require_reference_native,
)

torch.set_num_threads(1)

MODULES = {"port": gpu_mod, "reference": ref_mod}


# -- the pieces ---------------------------------------------------------------
@pytest.mark.parametrize("pkg", sorted(MODULES))
def test_drain_set_errors_swallow_and_backpressure(pkg):
    """``tests/test_tpu_storage.py``'s ``_DrainSet`` script: ``finish()``
    re-raises the first drain error once every drain landed and is a no-op
    after; ``finish(swallow=True)`` waits and never raises; with
    ``inflight=2`` the third live submit waits out the oldest (released by
    a timer) and calls ``on_block`` once."""
    drain_set = MODULES[pkg]._DrainSet
    pool = cf.ThreadPoolExecutor(4)
    try:
        blocks = []
        ds = drain_set(pool, inflight=2,
                       on_block=lambda: blocks.append(time.perf_counter()))
        done = []

        def ok(i):
            time.sleep(0.01)
            done.append(i)

        def boom(i):
            raise RuntimeError(f"drain {i} failed")

        ds.submit(ok, 1)
        ds.submit(boom, 2)
        ds.submit(ok, 3)
        with pytest.raises(RuntimeError, match="drain 2 failed"):
            ds.finish()
        assert sorted(done) == [1, 3]
        ds.finish()
        ds.submit(boom, 4)
        ds.finish(swallow=True)
        gate = threading.Event()
        slow_done = []

        def slow(i):
            gate.wait(5.0)
            slow_done.append(i)

        ds.submit(slow, 1)
        ds.submit(slow, 2)
        assert not blocks
        timer = threading.Timer(0.2, gate.set)
        timer.start()
        t0 = time.perf_counter()
        ds.submit(slow, 3)
        blocked = time.perf_counter() - t0
        ds.finish()
        timer.join(5.0)
        assert sorted(slow_done) == [1, 2, 3]
        assert blocked >= 0.15, blocked
        assert len(blocks) == 1
    finally:
        pool.shutdown(wait=True)


def _pool_script(pool):
    """One take / give script; returns, per take, the index of the given
    buffer it handed back (None: a fresh one), the shapes and dtypes."""
    given: list = []

    def take(shape, dtype):
        arr = pool.take(shape, dtype)
        hit = next((i for i, g in enumerate(given) if g is arr), None)
        return hit, arr.shape, arr.dtype.str

    def give(arr):
        given.append(arr)
        pool.give(arr)

    log = []
    a = pool.take(1024, np.uint32)
    b = pool.take((256, 3), np.uint8)
    give(a)
    give(b)
    log.append(take(1024, np.int32))        # another dtype: a miss
    log.append(take((1024,), np.uint32))    # the same key: a
    log.append(take((256, 3), np.uint8))    # b
    log.append(take((256, 3), np.uint8))    # empty again
    big = [pool.take(4096, np.uint32) for _ in range(3)]  # 16 KiB each
    for arr in big:
        give(arr)                           # the third is past the budget
    log.extend(take(4096, np.uint32) for _ in range(3))
    give(pool.take(8, np.int64))
    log.append(take(8, np.int64))
    return log


def test_staging_pool_matches_reference():
    """The same script on ``_StagingPool(max_bytes=40 KiB)`` of both
    packages: every take hands back the same given buffer (or a fresh
    one, last given first) with the same shape and dtype, so the keys and
    the byte budget agree.  The port's pool also counts its takes and
    hits, and no buffer came back while its event was pending."""
    port = gpu_mod._StagingPool(max_bytes=40 << 10)
    ref = ref_mod._StagingPool(max_bytes=40 << 10)
    log = _pool_script(port)
    assert log == _pool_script(ref)
    assert [hit for hit, _, _ in log] == [None, 0, 1, None, 3, 2, None, 5]
    stats = port.stats()
    assert (stats["takes"], stats["hits"], stats["early"]) == (14, 5, 0)
    assert stats["misses"] == stats["takes"] - stats["hits"]


# -- the prefetched assign and its abort --------------------------------------
def _chaos_pair(host_parallel=0):
    """The chaos scenario's 64-slot storages, one limiter (max 3), frozen
    clocks."""
    require_reference_native()
    now = [8_000_000]
    cfg = dict(max_permits=3, window_ms=60_000, refill_rate=0.001)
    port = GpuBatchedStorage(num_slots=64, clock_ms=lambda: now[0],
                             device="cpu", host_parallel=host_parallel)
    ref = TpuBatchedStorage(num_slots=64, clock_ms=lambda: now[0],
                            host_parallel=host_parallel)
    lid = port.register_limiter("tb", RateLimitConfig(**cfg))
    assert ref.register_limiter("tb", RefConfig(**cfg)) == lid
    return port, ref, lid


def _chaos_stream():
    """4 chunks of 128 requests over 40 keys each: later chunks evict
    earlier chunks' keys from the 64-slot table."""
    rng = np.random.default_rng(9)
    return np.concatenate([rng.integers(c * 40, c * 40 + 40, 128)
                           for c in range(4)]).astype(np.int64)


def _no_pin_left(storage):
    """A table's worth of fresh keys assigns every slot: a leaked pin
    would leave the last key without a victim (``tests/test_chaos.py``)."""
    fresh = np.arange(10_000_000, 10_000_064, dtype=np.int64)
    slots, _ = storage._index["tb"].assign_batch_ints(fresh, 0)
    assert len(set(slots.tolist())) == 64


def _recovery(port, ref, lid):
    """After the failure: no pin left on either, and 64 fresh keys see
    their full budget three times over, equal on both packages."""
    for st in (port, ref):
        _no_pin_left(st)
    fresh = np.arange(20_000_000, 20_000_064, dtype=np.int64)
    for _ in range(3):
        got = port.acquire_stream_ids("tb", lid, fresh, None)
        np.testing.assert_array_equal(
            got, ref.acquire_stream_ids("tb", lid, fresh, None))
        assert got.all(), "stale device state survived the failure"
    np.testing.assert_array_equal(port.engine.tb_packed.numpy(),
                                  np.asarray(ref.engine.tb_packed))


def _fail_after(fn, n):
    calls = {"n": 0}

    def wrapped(*a, **kw):
        calls["n"] += 1
        if calls["n"] == n + 1:
            raise RuntimeError("injected failure")
        return fn(*a, **kw)
    return wrapped


def _patch_chunks(monkeypatch, chunk, chunk_max):
    for mod in MODULES.values():
        monkeypatch.setattr(mod, "_RELAY_CHUNK", chunk)
        monkeypatch.setattr(mod, "_RELAY_CHUNK_MAX", chunk_max)


def test_second_dispatch_failure_recovers_like_reference(monkeypatch):
    """``tests/test_chaos.py:test_stream_failure_with_prefetched_assign_
    clears_evictions`` on both packages: the second digest dispatch
    raises; every evicted slot is cleared and every pin released."""
    _patch_chunks(monkeypatch, 128, 128)
    port, ref, lid = _chaos_pair()
    try:
        for st in (port, ref):
            st.engine.tb_relay_counts_dispatch = _fail_after(
                st.engine.tb_relay_counts_dispatch, 1)
            with pytest.raises(RuntimeError, match="injected"):
                st.acquire_stream_ids("tb", lid, _chaos_stream(), None)
        _recovery(port, ref, lid)
    finally:
        port.close()
        ref.close()


def test_drain_failure_aborts_the_prefetch_like_reference(monkeypatch):
    """The first chunk's drain sleeps 0.5 s, then raises; with
    ``_DRAIN_INFLIGHT`` 0 the submit waits it out and the error leaves
    the loop while the second chunk's assign is prefetched.  On both
    packages ``_abort_prefetch`` consumes that assign (its evictions
    cleared, its pins released), and recovery decides alike."""
    _patch_chunks(monkeypatch, 128, 128)
    monkeypatch.setattr(gpu_mod, "_DRAIN_INFLIGHT", 0)
    ref_drain_set = ref_mod._DrainSet
    monkeypatch.setattr(
        ref_mod, "_DrainSet",
        lambda pool, inflight=0, on_block=None: ref_drain_set(pool, 0,
                                                              on_block))

    def failing(decide):
        calls = {"n": 0}

        def wrapped(*a, **kw):
            calls["n"] += 1
            if calls["n"] == 1:
                # Still running when the submit looks at it.
                time.sleep(0.5)
                raise RuntimeError("injected drain failure")
            return decide(*a, **kw)
        return wrapped
    monkeypatch.setattr(gpu_mod, "relay_decide",
                        failing(gpu_mod.relay_decide))
    monkeypatch.setattr(ref_native, "relay_decide",
                        failing(ref_native.relay_decide))
    port, ref, lid = _chaos_pair()
    try:
        for st in (port, ref):
            consumed = []
            abort = st._abort_prefetch

            def spy(algo, index, fut, slots_of, abort=abort,
                    consumed=consumed):
                consumed.append(fut.exception() is None)
                abort(algo, index, fut, slots_of)
            st._abort_prefetch = spy
            with pytest.raises(RuntimeError, match="injected drain"):
                st.acquire_stream_ids("tb", lid, _chaos_stream(), None)
            assert consumed == [True]
        _recovery(port, ref, lid)
    finally:
        port.close()
        ref.close()


# -- drains out of order under a forced pipelined plan -------------------------
SCHEDULE = {"kind": "pipelined", "schedule": (256, 1024, 512),
            "chunk": 1024, "ref": 1e9, "giant_wall": 1e9, "passes": 0,
            "best": None}


@pytest.mark.parametrize("host_parallel", [0, 4])
@pytest.mark.parametrize("route", ["relay", "weighted", "scan"])
def test_out_of_order_drains_decide_like_reference(monkeypatch, route,
                                                   host_parallel):
    """A 4096-request stream of 1500 keys, three passes a second apart:
    the relay and the weighted relay under a forced pipelined schedule
    (``_RELAY_CHUNK`` 256), the flat scan in 1024-request super-batches of
    256-lane steps (``_FLAT_MAX_LANES`` 256, permits in [0, 300]).  The
    port's first drain of each pass waits until a later one has landed;
    decisions, the chunks' sizes and both state tables equal the
    reference's, and every chunk record carries its walk and fetch
    windows."""
    require_reference_native()
    _patch_chunks(monkeypatch, 256, 1 << 14)
    for mod in MODULES.values():
        monkeypatch.setattr(mod, "_FLAT_MAX_LANES", 256)
    now = [1_000_000]
    rng = np.random.default_rng(3)
    n = 4096
    ids = rng.integers(0, 1500, n).astype(np.int64)
    perms = {"relay": None,
             "weighted": rng.integers(1, 8, n).astype(np.int64),
             "scan": rng.integers(0, 301, n).astype(np.int64)}[route]
    algo = "sw" if route == "scan" else "tb"
    cfg = (dict(max_permits=400, window_ms=60_000) if algo == "sw"
           else dict(max_permits=20, window_ms=60_000, refill_rate=1.0))
    port = GpuBatchedStorage(num_slots=4096, clock_ms=lambda: now[0],
                             device="cpu", host_parallel=host_parallel)
    ref = TpuBatchedStorage(num_slots=4096, clock_ms=lambda: now[0],
                            host_parallel=host_parallel)
    landed = []
    later = threading.Event()  # set once a later drain has landed
    fetch = port._fetch

    def held_fetch(algo_, path, t0, land, decode, lid=None, waits=None):
        first = not landed
        if first:
            landed.append(None)
            later.wait(5.0)
        got = fetch(algo_, path, t0, land, decode, lid, waits)
        landed.append(t0)
        if not first:
            later.set()
        return got
    port._fetch = held_fetch
    try:
        lid = port.register_limiter(algo, RateLimitConfig(**cfg))
        assert ref.register_limiter(algo, RefConfig(**cfg)) == lid
        key = (("weighted", "ints", "tb", n) if route == "weighted"
               else ("relay", "ints", "tb", False, n))
        for st in (port, ref):
            st._chunk_plans[key] = dict(SCHEDULE)
        for _ in range(3):
            landed.clear()
            later.clear()
            ref.stream_stats = stats = []
            want = ref.acquire_stream_ids(algo, lid, ids, perms,
                                          batch=256, subbatches=4)
            ref.stream_stats = None
            got = port.acquire_stream_ids(algo, lid, ids, perms,
                                          batch=256, subbatches=4)
            np.testing.assert_array_equal(got, want)
            chunks = port.last_stream_chunks
            sizes = [rec["requests"] for rec in chunks]
            if route == "scan":
                assert sizes == [1024] * 4
                assert {rec["mode"] for rec in chunks} == {"scan"}
            else:
                assert sizes == [rec["n"] for rec in stats]
                assert sizes == [256, 1024, 512, 512, 512, 512, 512, 256]
            # The held first drain landed after a later chunk's.
            starts = landed[1:]
            assert starts.index(min(starts)) > 0
            for rec in chunks:
                assert rec["walk_at"][0] <= rec["walk_at"][1]
                assert rec["fetch_at"][0] <= rec["fetch_at"][1]
                assert rec["drain_s"] >= rec["fetch_s"] >= 0
            now[0] += 700
        for name in ("tb_packed", "sw_packed"):
            np.testing.assert_array_equal(
                getattr(port.engine, name).numpy(),
                np.asarray(getattr(ref.engine, name)))
    finally:
        port.close()
        ref.close()


def test_close_stops_the_pipeline_workers(monkeypatch):
    """A pipelined pass starts the prefetch worker (``assignpf``) and the
    drain workers; ``close()`` shuts both pools down and their threads
    end."""
    monkeypatch.setattr(gpu_mod, "_RELAY_CHUNK", 256)
    st = GpuBatchedStorage(num_slots=4096, device="cpu", host_parallel=0)
    lid = st.register_limiter("tb", RateLimitConfig(
        max_permits=20, window_ms=60_000, refill_rate=1.0))
    ids = np.random.default_rng(5).integers(0, 2000, 2048).astype(np.int64)
    st.acquire_stream_ids("tb", lid, ids)
    assert len(st.last_stream_chunks) > 1
    threads = (list(st._assign_pool_obj._threads)
               + list(st._drain_pool_obj._threads))
    names = {t.name.rsplit("_", 1)[0] for t in threads}
    assert names == {"assignpf", "drain"}
    st.close()
    for t in threads:
        t.join(5.0)
    assert not any(t.is_alive() for t in threads)


# -- C18: a saturated shard lane reaches the flight recorder -------------------
@pytest.mark.parametrize("pkg", sorted(MODULES))
def test_shard_lane_saturation_is_recorded(pkg, monkeypatch):
    """A lane of either package whose drains are held past
    ``_SHARD_DRAIN_INFLIGHT`` (2) waits in the third submit, counts it in
    ``saturated`` and records one ``shard.drain_saturated`` event with its
    shard to the recorder it was built with."""
    mod = MODULES[pkg]
    recorder = (FlightRecorder if pkg == "port" else RefRecorder)()
    lane = mod._ShardLane(3, recorder=recorder)
    gate = threading.Event()
    try:
        for _ in range(2):
            lane.drains.submit(gate.wait, 5.0)
        assert lane.saturated == 0
        timer = threading.Timer(0.1, gate.set)
        timer.start()
        lane.drains.submit(gate.wait, 5.0)
        lane.drains.finish()
        timer.join(5.0)
        assert lane.saturated == 1
        events = recorder.events("shard.drain_saturated")
        assert [e["shard"] for e in events] == [3]
    finally:
        gate.set()
        lane.close()


def test_storage_shard_lanes_record_to_its_recorder():
    """The port's storage builds its shard lanes with its own flight
    recorder (the reference's ``storage/tpu.py:3100``), so a saturated
    lane of a sharded stream shows there."""
    recorder = FlightRecorder()
    devices = [torch.device("cpu")] * 2
    eng = ShardedDeviceEngine(1 << 10, LimiterTable(device="cpu"),
                              devices=devices)
    st = GpuBatchedStorage(engine=eng, recorder=recorder)
    gate = threading.Event()
    try:
        lane = st._shard_lanes(2)[1]
        for _ in range(2):
            lane.drains.submit(gate.wait, 5.0)
        threading.Timer(0.1, gate.set).start()
        lane.drains.submit(gate.wait, 5.0)
        lane.drains.finish()
        assert [e["shard"] for e in recorder.events(
            "shard.drain_saturated")] == [1]
    finally:
        gate.set()
        st.close()
