"""The hybrid host-side serving tier (``cache/hybrid.py``) over the
storage, port against the JAX package: the eight cases of
``tests/test_hybrid_cache.py``, each run on ``TpuBatchedStorage`` and on
``GpuBatchedStorage(device="cpu")`` with ``serving_cache=True``, the same
explicit ``host_parallel``, traffic and manual clock.

Adoption and confirmation land on drain-thread callbacks that race the
caller's ``Future.result()``.  After every call both storages are
quiesced — flushed, then polled (with a bound) until the batcher holds no
unresolved future, which it drops only after the future's callbacks ran —
so the tier's state is settled before the next call.  Then every decision
dict (``host_served`` included), the tier's ``stats()`` and
``pending_confirms()``, and each key's packed row must be equal, and each
decision must equal the oracle's.
"""

import random
import time

import numpy as np
import pytest
import torch

from ratelimiter_tpu.core.config import RateLimitConfig as RefConfig
from ratelimiter_tpu.storage.tpu import TpuBatchedStorage
from ratelimiter_tpu_torch import RateLimitConfig
from ratelimiter_tpu_torch.semantics import (
    SlidingWindowOracle,
    TokenBucketOracle,
)
from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage
from torch_reference_native import (  # noqa: F401 (autouse fixture)
    idle_reference_flushers,
    require_reference_native,
)

torch.set_num_threads(1)


def _wait_for(cond, timeout=10.0):
    """Poll ``cond`` with a bound (never a fixed sleep)."""
    deadline = time.time() + timeout
    while not cond() and time.time() < deadline:
        time.sleep(0.002)
    assert cond()


def _quiesce(st):
    st.flush()
    _wait_for(lambda: not st._batcher._waiters)


class _Pair:
    """Both packages' storages with the serving tier on, one clock."""

    def __init__(self, clock, host_parallel=0, **kw):
        require_reference_native()
        kw.setdefault("num_slots", 1 << 10)
        kw.setdefault("max_delay_ms", 0.2)
        now = lambda: clock[0]  # noqa: E731
        self.ref = TpuBatchedStorage(clock_ms=now, serving_cache=True,
                                     host_parallel=host_parallel, **kw)
        self.port = GpuBatchedStorage(clock_ms=now, serving_cache=True,
                                      device="cpu",
                                      host_parallel=host_parallel, **kw)

    def register(self, algo, **cfg):
        a = self.ref.register_limiter(algo, RefConfig(**cfg))
        b = self.port.register_limiter(algo, RateLimitConfig(**cfg))
        assert a == b
        return b

    def each(self, fn, quiesce=True):
        """``fn(storage)`` on both (reference first); both results."""
        out = []
        for st in (self.ref, self.port):
            out.append(fn(st))
            if quiesce:
                _quiesce(st)
        return out

    def acquire(self, algo, lid, key, permits):
        want, got = self.each(lambda st: st.acquire(algo, lid, key, permits))
        want = {k: int(v) for k, v in want.items()}
        got = {k: int(v) for k, v in got.items()}
        assert got == want, (algo, lid, key, permits, got, want)
        assert self.port._serving.stats() == self.ref._serving.stats()
        return got

    def rows_equal(self, algo, lid, keys):
        for key in keys:
            rows = []
            for st in (self.ref, self.port):
                slot = st._index[algo].get((lid, key))
                rows.append(None if slot is None else
                            st.engine.read_rows(algo, [slot])[0].tolist())
            assert rows[0] == rows[1], key

    def close(self):
        self.ref.close()
        self.port.close()


def _check(out, d, algo):
    assert bool(out["allowed"]) == d.allowed
    assert int(out["observed"]) == d.observed
    if algo == "sw":
        assert bool(out["mutated"]) == d.mutated
        assert int(out["cache_value"]) == d.remaining_hint
    else:
        assert int(out["remaining"]) == d.remaining_hint


@pytest.mark.parametrize("host_parallel", [0, 4])
def test_hybrid_bit_identity_sw(host_parallel):
    """Repeat traffic over few keys, the clock crossing windows and
    deadlines, and mid-stream resets: every decision equal on both sides
    and to the oracle, and the tier serves."""
    clock = [10_000]
    pair = _Pair(clock, host_parallel, serving_cache_ttl_ms=10_000.0)
    try:
        cfg = dict(max_permits=4, window_ms=500)
        lid = pair.register("sw", **cfg)
        oracle = SlidingWindowOracle(RateLimitConfig(**cfg))
        rng = random.Random(3)
        keys = [f"h{i}" for i in range(4)]
        served = 0
        for step in range(500):
            clock[0] += rng.choice([0, 0, 0, 1, 7, 80, 700])
            key = rng.choice(keys)
            if step % 90 == 89:
                pair.each(lambda st: st.reset_key("sw", lid, key))
                oracle.reset(key, clock[0])
                continue
            permits = rng.choice([1, 1, 2])
            out = pair.acquire("sw", lid, key, permits)
            _check(out, oracle.try_acquire(key, permits, clock[0]), "sw")
            served += out.get("host_served", 0)
        assert served > 0
        assert pair.port._serving.divergence == 0
        pair.rows_equal("sw", lid, keys)
    finally:
        pair.close()


@pytest.mark.parametrize("host_parallel", [0, 4])
def test_hybrid_bit_identity_tb(host_parallel):
    clock = [10_000]
    pair = _Pair(clock, host_parallel, serving_cache_ttl_ms=10_000.0)
    try:
        cfg = dict(max_permits=6, window_ms=1000, refill_rate=3.0)
        lid = pair.register("tb", **cfg)
        oracle = TokenBucketOracle(RateLimitConfig(**cfg))
        rng = random.Random(11)
        keys = [f"t{i}" for i in range(3)]
        served = 0
        for _ in range(450):
            clock[0] += rng.choice([0, 0, 1, 30, 400, 5000])
            key = rng.choice(keys)
            permits = rng.choice([1, 1, 2, 3, 6, 7])
            out = pair.acquire("tb", lid, key, permits)
            _check(out, oracle.try_acquire(key, permits, clock[0]), "tb")
            served += out.get("host_served", 0)
        assert served > 0
        assert pair.port._serving.divergence == 0
        pair.rows_equal("tb", lid, keys)
    finally:
        pair.close()


def test_hybrid_bit_identity_under_slot_churn():
    """A table barely above the working set: evictions remap slots all
    the time, and the tier must invalidate at remap time."""
    clock = [10_000]
    pair = _Pair(clock, num_slots=1 << 5, serving_cache_ttl_ms=60_000.0)
    try:
        cfg = dict(max_permits=5, window_ms=60_000)
        lid = pair.register("sw", **cfg)
        oracle = SlidingWindowOracle(RateLimitConfig(**cfg))
        rng = random.Random(5)
        keys = [f"c{i}" for i in range(48)]
        for _ in range(500):
            clock[0] += rng.choice([0, 0, 1])
            key = rng.choice(keys)
            before = pair.port._index["sw"].get((lid, key))
            assert (before is None) == (
                pair.ref._index["sw"].get((lid, key)) is None)
            out = pair.acquire("sw", lid, key, 1)
            if before is None:
                oracle.reset(key, clock[0])
            _check(out, oracle.try_acquire(key, 1, clock[0]), "sw")
        assert pair.port._serving.divergence == 0
        assert pair.port._serving.invalidated > 0
        pair.rows_equal("sw", lid, keys)
    finally:
        pair.close()


def test_hybrid_over_admission_bounded_under_adversarial_divergence():
    """Device state mutated behind the tier (``acquire_many``): combined
    admission stays within 2 * max_permits per key and window, and the
    divergence is detected, the same on both sides."""
    clock = [10_000]
    pair = _Pair(clock, serving_cache_ttl_ms=60_000.0,
                 serving_cache_unconfirmed_cap=1 << 20)
    try:
        cfg = dict(max_permits=8, window_ms=60_000)
        lid = pair.register("sw", **cfg)
        key = "victim"
        total = int(pair.acquire("sw", lid, key, 1)["allowed"])
        assert len(pair.port._serving) == len(pair.ref._serving) == 1
        want, got = pair.each(lambda st: st.acquire_many(
            "sw", [lid] * 6, [key] * 6, [1] * 6))
        np.testing.assert_array_equal(got["allowed"], want["allowed"])
        total += int(got["allowed"].sum())
        for _ in range(30):
            total += int(pair.acquire("sw", lid, key, 1)["allowed"])
        assert total <= 2 * cfg["max_permits"]
        tier = pair.port._serving
        assert tier.divergence > 0 or tier.invalidated > 0
        assert tier.stats() == pair.ref._serving.stats()
        pair.rows_equal("sw", lid, [key])
    finally:
        pair.close()


def test_hybrid_unconfirmed_cap_forces_device_path():
    """With the flusher held back (a long fixed deadline), forwarded
    confirmations cannot drain; at the cap the tier drops the entry and
    the caller rides the device path — on both sides."""
    clock = [10_000]
    pair = _Pair(clock, max_delay_ms=5_000.0, adaptive_flush=False,
                 serving_cache_unconfirmed_cap=2,
                 serving_cache_ttl_ms=60_000.0)
    try:
        lid = pair.register("sw", max_permits=1000, window_ms=60_000)
        seen = []
        for st in (pair.ref, pair.port):
            f0 = st.acquire_async("sw", lid, "k", 1)
            st.flush()
            assert bool(f0.result(timeout=30)["allowed"])
            _wait_for(lambda: len(st._serving) == 1)  # adopted
            f1 = st.acquire_async("sw", lid, "k", 1)
            f2 = st.acquire_async("sw", lid, "k", 1)
            assert f1.done() and f2.done()  # host-served at once
            served = st._serving.served
            f3 = st.acquire_async("sw", lid, "k", 1)  # cap -> device
            assert not f3.done()
            assert st._serving.served == served
            assert len(st._serving) == 0
            st.flush()
            out = f3.result(timeout=30)
            _quiesce(st)
            seen.append(({k: int(v) for k, v in out.items()
                          if k != "stamp"},
                         st._serving.stats()))
        assert seen[0] == seen[1]
        assert seen[1][1]["divergence"] == 0
    finally:
        pair.close()


def test_hybrid_eviction_invalidates_entry():
    clock = [10_000]
    pair = _Pair(clock, serving_cache_ttl_ms=60_000.0)
    try:
        lid = pair.register("sw", max_permits=5, window_ms=60_000)
        pair.acquire("sw", lid, "evictme", 1)
        for st in (pair.ref, pair.port):
            assert len(st._serving) == 1
            slot = st._index["sw"].get((lid, "evictme"))
            st._clear_slots("sw", [slot])
            assert len(st._serving) == 0
        assert pair.port._serving.stats() == pair.ref._serving.stats()
    finally:
        pair.close()


def test_hybrid_reset_key_invalidates_entry():
    clock = [10_000]
    pair = _Pair(clock, serving_cache_ttl_ms=60_000.0)
    try:
        lid = pair.register("sw", max_permits=5, window_ms=60_000)
        pair.acquire("sw", lid, "r", 1)
        assert len(pair.port._serving) == 1
        pair.each(lambda st: st.reset_key("sw", lid, "r"))
        assert len(pair.port._serving) == len(pair.ref._serving) == 0
        out = pair.acquire("sw", lid, "r", 1)
        assert out["allowed"] and out["observed"] == 0
        pair.rows_equal("sw", lid, ["r"])
    finally:
        pair.close()


def test_hybrid_repeat_reject_served_without_device_traffic():
    """Once a key is at its limit, rejects resolve host-side with no
    batcher submission and no kernel step, on both sides; a live
    ``set_policy`` then drops the lid's entries before the row moves."""
    clock = [10_000]
    pair = _Pair(clock, serving_cache_ttl_ms=60_000.0)
    try:
        lid = pair.register("sw", max_permits=2, window_ms=60_000)
        for _ in range(4):
            pair.acquire("sw", lid, "hot", 1)  # 2 allowed, then rejects
        assert len(pair.port._serving) == 1
        before = [(st._serving.rejects_served, st._batcher.max_depth_seen,
                   st.trace.snapshot()["total_dispatches"])
                  for st in (pair.ref, pair.port)]
        for _ in range(20):
            out = pair.acquire("sw", lid, "hot", 1)
            assert not out["allowed"] and out["host_served"]
        for (rej, depth, dispatches), st in zip(before,
                                                (pair.ref, pair.port)):
            assert st._serving.rejects_served - rej == 20
            assert st._batcher.max_depth_seen == depth
            assert st.trace.snapshot()["total_dispatches"] == dispatches
        pair.each(lambda st: st.set_policy(
            lid, (RefConfig if st is pair.ref else RateLimitConfig)(
                max_permits=3, window_ms=60_000)))
        assert len(pair.port._serving) == len(pair.ref._serving) == 0
        out = pair.acquire("sw", lid, "hot", 1)
        assert out["allowed"] and not out.get("host_served")
        assert pair.port._serving.divergence == 0
        assert pair.port.policy_info() == pair.ref.policy_info()
    finally:
        pair.close()
