"""The stream path's spans and per-chunk counters, on the CPU.

A string stream goes through a limiter's ``try_acquire_many`` (→
``acquire_stream_strs``) and an integer-id stream through its
``try_acquire_stream_ids`` (→ ``acquire_stream_ids``), on a CPU storage
of 2^16 slots with a partitioned host index, in several chunks:

- under ``torch.profiler.profile(activities=[CPU])`` the exported trace
  holds each calling-thread span (``utils/tracing.py:SPANS``) as a
  ``user_annotation`` on the calling thread, and no ``rl.`` name outside
  ``SPANS``;
- under ``device_profile``, which records every thread where torch can,
  the trace also holds the worker threads' ``rl.index.hash``,
  ``rl.index.key_pack`` and ``rl.stream.drain``;
- with no profiler running no ``record_function`` is entered;
- each chunk record (``last_stream_chunks`` and ``stream_stats``, on the
  relay, weighted and flat loops, on one index and on partitions) holds
  ``assign_wait_s >= 0`` and, of string keys, ``0 <= key_pack_s <=
  hash_s <= assign_s``; integer keys' records hold neither.
"""

import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ratelimiter_tpu_torch import RateLimitConfig
from ratelimiter_tpu_torch.algorithms import (
    SlidingWindowRateLimiter,
    TokenBucketRateLimiter,
)
from ratelimiter_tpu_torch.algorithms import sliding_window as sw_mod
from ratelimiter_tpu_torch.algorithms import token_bucket as tb_mod
from ratelimiter_tpu_torch.metrics import MeterRegistry
from ratelimiter_tpu_torch.storage import gpu as gpu_mod
from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage
from ratelimiter_tpu_torch.utils import tracing
from ratelimiter_tpu_torch.utils.tracing import SPANS, device_profile

torch.set_num_threads(1)

T0 = 1_700_000_000_000
SLOTS = 1 << 16
N = 6_000
LIMITERS = {
    "tb": (TokenBucketRateLimiter,
           dict(max_permits=30, window_ms=2_000, refill_rate=10.0)),
    "sw": (SlidingWindowRateLimiter,
           dict(max_permits=40, window_ms=2_000, enable_local_cache=False)),
}
CALLING_THREAD = (
    tracing.LIMITER_TRY_ACQUIRE_MANY, tracing.LIMITER_TRY_ACQUIRE_STREAM_IDS,
    tracing.STREAM_ASSIGN, tracing.STREAM_ASSIGN_WAIT,
    tracing.STREAM_DISPATCH, tracing.STREAM_DRAIN_WAIT,
)
WORKER = (tracing.INDEX_HASH, tracing.INDEX_KEY_PACK, tracing.STREAM_DRAIN)


@pytest.fixture
def small_chunks(monkeypatch):
    """Relay chunks of 1024 requests growing to 2048 at most, flat steps
    of at most 512 lanes, and the limiters' string stream from 1024
    keys: a call of ``N`` keys takes several chunks."""
    monkeypatch.setattr(gpu_mod, "_RELAY_CHUNK", 1024)
    monkeypatch.setattr(gpu_mod, "_RELAY_CHUNK_MAX", 2048)
    monkeypatch.setattr(gpu_mod, "_FLAT_MAX_LANES", 512)
    monkeypatch.setattr(tb_mod, "_STREAM_MIN", 1024)
    monkeypatch.setattr(sw_mod, "_STREAM_MIN", 1024)


class Rig:
    """A CPU storage of ``SLOTS`` slots (``host_parallel`` partitions, 0
    for one index) under one limiter of ``algo``, on a clock that moves
    a second a call, and Zipf keys."""

    def __init__(self, algo, host_parallel=4):
        self.t = T0
        self.storage = GpuBatchedStorage(num_slots=SLOTS,
                                         clock_ms=self.now, device="cpu",
                                         host_parallel=host_parallel)
        cls, cfg = LIMITERS[algo]
        self.limiter = cls(self.storage, RateLimitConfig(**cfg),
                           MeterRegistry(), clock_ms=self.now)
        self.rng = np.random.default_rng(7 if algo == "tb" else 8)

    def now(self) -> int:
        return self.t

    def ids(self, n=N):
        return ((self.rng.zipf(1.1, n) - 1) % 3_000).astype(np.int64)

    def strs(self):
        self.t += 1_000
        return self.limiter.try_acquire_many([f"k{i}" for i in self.ids()])

    def ints(self):
        self.t += 1_000
        return self.limiter.try_acquire_stream_ids(self.ids())

    def close(self):
        self.storage.close()


def _user_spans(path):
    """(name, tid) of the trace's ``rl.`` user annotations."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(ev["name"], ev.get("tid")) for ev in events
            if ev.get("ph") == "X" and ev.get("cat") == "user_annotation"
            and ev.get("name", "").startswith("rl.")]


@pytest.mark.parametrize("algo", ["tb", "sw"])
def test_calling_thread_spans_in_a_cpu_profile(algo, small_chunks,
                                               tmp_path):
    rig = Rig(algo)
    try:
        rig.strs()  # the index and plans settle outside the profile
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            rig.strs()
            rig.ints()
        assert len(rig.storage.last_stream_chunks) > 1
        path = str(tmp_path / "trace.json")
        prof.export_chrome_trace(path)
    finally:
        rig.close()
    spans = _user_spans(path)
    caller = threading.get_native_id()
    on_caller = {name for name, tid in spans if tid == caller}
    assert set(CALLING_THREAD) <= on_caller
    assert {name for name, _ in spans} <= set(SPANS)


@pytest.mark.parametrize("algo", ["tb", "sw"])
def test_device_profile_holds_the_worker_spans(algo, small_chunks,
                                               tmp_path):
    rig = Rig(algo)
    try:
        rig.strs()
        with device_profile(str(tmp_path)) as prof:
            rig.strs()
            rig.ints()
    finally:
        rig.close()
    spans = _user_spans(prof.trace_path)
    names = {name for name, _ in spans}
    assert set(CALLING_THREAD) <= names <= set(SPANS)
    caller = threading.get_native_id()
    off_caller = {name for name, tid in spans if tid != caller}
    if tracing.all_threads_config() is None:
        assert off_caller == set()  # this torch records the caller only
    else:
        assert set(WORKER) <= off_caller


def test_no_record_function_without_a_profiler(small_chunks, monkeypatch):
    entered = []
    real = torch.autograd.profiler.record_function.__enter__

    def counted(self):
        entered.append(self.name)
        return real(self)
    monkeypatch.setattr(torch.autograd.profiler.record_function,
                        "__enter__", counted)
    rig = Rig("tb")
    try:
        rig.strs()
        rig.ints()
        assert entered == []
        assert tracing.span(tracing.STREAM_ASSIGN) is tracing.span(
            tracing.STREAM_DRAIN)
        with profile(activities=[ProfilerActivity.CPU]):
            rig.strs()
        assert set(CALLING_THREAD) - {
            tracing.LIMITER_TRY_ACQUIRE_STREAM_IDS} <= set(entered)
    finally:
        rig.close()


@pytest.mark.parametrize("host_parallel", [0, 4])
@pytest.mark.parametrize("permits", ["unit", "weighted", "flat"])
def test_chunk_counters(permits, host_parallel, small_chunks):
    """Relay (unit permits), weighted relay (permits in [1, 45]) and flat
    (permits past the weighted cap, super-batches of 4 x 256 requests)
    loops, string keys and int keys."""
    rig = Rig("tb", host_parallel)
    st = rig.storage
    try:
        for strs in (True, False):
            ids = rig.ids()
            p = {"unit": None, "weighted": 1 + ids % 45,
                 "flat": 1 + ids % 400}[permits]
            keys = [f"k{i}" for i in ids] if strs else ids
            fn = st.acquire_stream_strs if strs else st.acquire_stream_ids
            rig.t += 1_000
            st.stream_stats = []
            try:
                fn("tb", 0, keys, p, batch=256, subbatches=4)
                stats = st.stream_stats
            finally:
                st.stream_stats = None
            chunks = st.last_stream_chunks
            assert len(stats) == len(chunks) > 1
            assert {r["path"] for r in stats} == {
                {"unit": "relay", "weighted": "relay_w",
                 "flat": "flat"}[permits]}
            # The first chunk's assign ran on the calling thread: its wait
            # is the whole assign.
            assert chunks[0]["assign_wait_s"] >= chunks[0]["assign_s"]
            for recs in (chunks, stats):
                for r in recs:
                    assert r["assign_wait_s"] >= 0
                    if strs:
                        assert (0 <= r["key_pack_s"] <= r["hash_s"]
                                <= r["assign_s"]), r
                    else:
                        assert "hash_s" not in r and "key_pack_s" not in r
    finally:
        rig.close()
