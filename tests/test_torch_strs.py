"""String-key streams against the JAX package.

- ``GpuBatchedStorage(device="cpu").acquire_stream_strs`` decides like
  ``TpuBatchedStorage.acquire_stream_strs`` on the same string keys,
  clock and chunking, on one host index and on 4 partitions, on small
  tables under eviction churn: unit permits (relay chunks electing the
  digest or words mode), permits in [1, 255] (the weighted relay's
  rank-major, coalesced and flat-fallback chunks), permits past the
  weighted cap and oversize permits (the flat step), and a limit past the
  relay word's count clamp (the flat step).  Each chunk's mode equals the
  one the reference's ``stream_stats`` record.
- The limiters' ``try_acquire_many`` goes through ``acquire_stream_strs``
  from ``_STREAM_MIN`` keys on both packages (made small here), and
  through one batch below it.
"""

import numpy as np
import pytest
import torch

from ratelimiter_tpu.algorithms import (
    SlidingWindowRateLimiter as RefSW,
    TokenBucketRateLimiter as RefTB,
)
from ratelimiter_tpu.algorithms import sliding_window as ref_sw_mod
from ratelimiter_tpu.algorithms import token_bucket as ref_tb_mod
from ratelimiter_tpu.core.config import RateLimitConfig as RefConfig
from ratelimiter_tpu.metrics import MeterRegistry as RefRegistry
from ratelimiter_tpu.storage import tpu as ref_storage_mod
from ratelimiter_tpu.storage.tpu import TpuBatchedStorage
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
from torch_reference_native import (  # noqa: F401 (autouse fixture)
    idle_reference_flushers,
    require_reference_native,
)

torch.set_num_threads(1)

CFG = {"tb": dict(max_permits=30, window_ms=2_000, refill_rate=10.0),
       "sw": dict(max_permits=40, window_ms=2_000,
                  enable_local_cache=False)}
# The reference's relay records name the digest and words modes by what
# goes up; the port's by route.
REF_MODE = {"digest": "relay", "bits": "words"}


class StrPair:
    """A reference and a port storage on one clock, with the same limiter
    and the same host index (``host_parallel`` partitions, 0 for one
    index)."""

    def __init__(self, algo, cfg, host_parallel, num_slots=1024):
        require_reference_native()
        self.algo = algo
        self.clock = {"t": 1_700_000_000_000}
        self.ref = TpuBatchedStorage(num_slots=num_slots,
                                     clock_ms=lambda: self.clock["t"],
                                     observability=False,
                                     host_parallel=host_parallel)
        self.port = GpuBatchedStorage(num_slots=num_slots,
                                      clock_ms=lambda: self.clock["t"],
                                      device="cpu",
                                      host_parallel=host_parallel)
        self.host_parallel = host_parallel
        self.lid = self.ref.register_limiter(algo, RefConfig(**cfg))
        assert self.port.register_limiter(
            algo, RateLimitConfig(**cfg)) == self.lid

    def call(self, dt, keys, permits=None, **kw):
        """One string stream call on both storages after the clock moves
        ``dt``: equal decisions, each chunk's mode the reference's; returns
        the port's chunk modes."""
        self.clock["t"] += dt
        self.ref.stream_stats = []
        want = self.ref.acquire_stream_strs(self.algo, self.lid, keys,
                                            permits, **kw)
        got = self.port.acquire_stream_strs(self.algo, self.lid, keys,
                                            permits, **kw)
        np.testing.assert_array_equal(got, want)
        assert 0 < got.sum() < len(keys)
        chunks = self.port.last_stream_chunks
        modes = [c["mode"] for c in chunks]
        assert modes == [REF_MODE.get(r["mode"], r["mode"])
                         for r in self.ref.stream_stats]
        self.ref.stream_stats = None
        assert sum(c["requests"] for c in chunks) == len(keys)
        for c in chunks:
            assert c["pack_s"] >= 0
            assert c.get("host_parallel", 0) == self.host_parallel
        return modes

    def close(self):
        self.ref.close()
        self.port.close()


def _zipf(rng, n, n_keys, prefix="k"):
    return [f"{prefix}{k}" for k in (rng.zipf(1.1, n) - 1) % n_keys]


def _uniform(rng, n, n_keys, prefix="u"):
    return [f"{prefix}{k}" for k in rng.integers(0, n_keys, n)]


@pytest.fixture
def small_relay_chunks(monkeypatch):
    """Relay chunks of 256 requests growing to 512 at most, in both
    storages, so each call spans several windows of its key list."""
    for mod in (ref_storage_mod, gpu_mod):
        monkeypatch.setattr(mod, "_RELAY_CHUNK", 256)
        monkeypatch.setattr(mod, "_RELAY_CHUNK_MAX", 512)


@pytest.fixture
def small_flat(monkeypatch):
    """Flat steps of at most 512 lanes in both storages."""
    for mod in (ref_storage_mod, gpu_mod):
        monkeypatch.setattr(mod, "_FLAT_MAX_LANES", 512)


@pytest.mark.parametrize("host_parallel", [0, 4])
@pytest.mark.parametrize("algo", ["tb", "sw"])
def test_string_relay_matches_reference(algo, host_parallel,
                                        small_relay_chunks):
    """Unit permits over 1024 slots: Zipf keys (digest chunks) and
    uniform keys over 3000 with one hot key past the limit (words chunks,
    evicting), in turns."""
    rng = np.random.default_rng(11 if algo == "tb" else 12)
    pair = StrPair(algo, CFG[algo], host_parallel)
    try:
        for rnd in range(3):
            assert set(pair.call(700, _zipf(rng, 1_500, 200))) == {"relay"}
            keys = rng.permutation(np.asarray(
                _uniform(rng, 1_140, 3_000) + ["hot"] * 60)).tolist()
            assert set(pair.call(900, keys)) == {"words"}
    finally:
        pair.close()


@pytest.mark.parametrize("host_parallel", [0, 4])
@pytest.mark.parametrize("algo", ["tb", "sw"])
def test_string_weighted_matches_reference(algo, host_parallel, small_flat):
    """Permits in [1, 45] of one limiter: rank-major chunks (uniform keys
    over 3000, evicting), coalesced chunks (one weight per key) and flat
    fallback chunks (a hot key past 64 repeats; flat steps of 512)."""
    rng = np.random.default_rng(21 if algo == "tb" else 22)
    pair = StrPair(algo, CFG[algo], host_parallel)
    try:
        for rnd in range(2):
            keys = _uniform(rng, 600, 3_000)
            assert pair.call(700, keys, rng.integers(1, 46, 600)) == [
                "weighted"]
            ids = (rng.zipf(1.1, 1_500) - 1) % 300
            assert pair.call(900, [f"z{k}" for k in ids],
                             1 + ids % 45) == ["weighted_coal"]
            keys = _zipf(rng, 1_500, 300, "z") + ["hot"] * 100
            assert pair.call(1_300, keys, rng.integers(1, 46, 1_600)) == [
                "flat_fb"]
    finally:
        pair.close()


@pytest.mark.parametrize("host_parallel", [0, 4])
@pytest.mark.parametrize("algo", ["tb", "sw"])
def test_string_flat_routes_match_reference(algo, host_parallel):
    """The flat step in super-batches of 256: permits past the weighted
    cap and oversize permits (denied, state untouched) over 3000 keys on
    1024 slots; then unit permits under a limit past the relay word's
    count clamp (2^15 - 1 at 2^16 - 64 slots), one key past the limit."""
    rng = np.random.default_rng(31 if algo == "tb" else 32)
    pair = StrPair(algo, CFG[algo], host_parallel)
    try:
        for rnd in range(2):
            keys = _uniform(rng, 700, 3_000)
            assert pair.call(600, keys, rng.integers(1, 400, 700),
                             batch=128, subbatches=2) == ["flat"] * 3
            permits = rng.integers(1, 40, 700)
            permits[rng.random(700) < 0.05] = np.iinfo(np.int64).max
            assert pair.call(800, _zipf(rng, 700, 400), permits,
                             batch=256, subbatches=2) == ["flat"] * 2
    finally:
        pair.close()
    wide = dict(CFG[algo], max_permits=40_000)
    pair = StrPair(algo, wide, host_parallel, num_slots=(1 << 16) - 64)
    try:
        assert not pair.port.engine.relay_usable()
        for rnd in range(2):
            keys = rng.permutation(np.asarray(
                ["hot"] * 41_000 + _uniform(rng, 600, 3_000))).tolist()
            assert pair.call(500, keys, batch=1 << 14, subbatches=2) == [
                "flat", "flat"]
    finally:
        pair.close()


def _spy(monkeypatch, storage, calls):
    real = storage.acquire_stream_strs

    def spy(*args, **kw):
        calls.append(args[3] is None if len(args) > 3
                     else kw.get("permits") is None)
        return real(*args, **kw)
    monkeypatch.setattr(storage, "acquire_stream_strs", spy)


@pytest.mark.parametrize("host_parallel", [0, 4])
def test_limiters_route_large_calls_to_string_streams(host_parallel,
                                                      monkeypatch):
    """With ``_STREAM_MIN`` at 256 in both packages: a token bucket and a
    cache-less sliding window send calls of 256 keys and more through
    ``acquire_stream_strs`` (unit permits without a permits lane), and
    smaller calls, and every call of a cached sliding window, through one
    batch; decisions agree."""
    for mod in (ref_tb_mod, ref_sw_mod, tb_mod, sw_mod):
        monkeypatch.setattr(mod, "_STREAM_MIN", 256)
    require_reference_native()
    clock = {"t": 1_700_000_000_000}
    storages = [TpuBatchedStorage(num_slots=1024,
                                  clock_ms=lambda: clock["t"],
                                  observability=False,
                                  host_parallel=host_parallel),
                GpuBatchedStorage(num_slots=1024,
                                  clock_ms=lambda: clock["t"], device="cpu",
                                  host_parallel=host_parallel)]
    try:
        calls = ([], [])
        lims = []
        for ref, st, seen in zip((True, False), storages, calls):
            _spy(monkeypatch, st, seen)
            reg = RefRegistry() if ref else MeterRegistry()
            cfg = RefConfig if ref else RateLimitConfig
            tb, sw = (RefTB, RefSW) if ref else (TokenBucketRateLimiter,
                                                 SlidingWindowRateLimiter)
            lims.append({
                "tb": tb(st, cfg(**CFG["tb"]), reg),
                "sw": sw(st, cfg(**CFG["sw"]), reg,
                         clock_ms=lambda: clock["t"]),
                "cached": sw(st, cfg(max_permits=40, window_ms=2_000,
                                     enable_local_cache=True), reg,
                             clock_ms=lambda: clock["t"])})
        rng = np.random.default_rng(41)
        for name, n, permits, streamed in (
                ("tb", 600, None, [True]), ("sw", 600, None, [True]),
                ("tb", 600, "lane", [False]), ("tb", 200, None, []),
                ("sw", 255, None, []), ("cached", 600, None, [])):
            clock["t"] += 300
            keys = _zipf(rng, n, 400)
            p = None if permits is None else rng.integers(1, 20, n).tolist()
            want = lims[0][name].try_acquire_many(keys, p)
            got = lims[1][name].try_acquire_many(keys, p)
            np.testing.assert_array_equal(got, want)
            assert calls[0] == calls[1] == streamed, (name, n, permits)
            if streamed and permits is None:
                assert {c["mode"] for c in
                        storages[1].last_stream_chunks} == {"relay"}
            for seen in calls:
                seen.clear()
    finally:
        for st in storages:
            st.close()
