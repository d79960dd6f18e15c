"""The legacy storage contract and the limiters over it, port against the
JAX package.

The same seeded calls on the same manual clock go through the port's
``InMemoryStorage`` / ``GpuBatchedStorage(device="cpu")`` and the
reference's ``InMemoryStorage`` / ``TpuBatchedStorage``: the ten legacy
methods, the sliding-window-log limiter over them, and the sliding-window
and token-bucket limiters' compat path over a storage that does not batch
on the device.  Results, exceptions and available permits must be equal.
The traffic repeats keys, crosses TTL deadlines and window boundaries,
runs keys to their ``max_permits`` and steps the clock backward.
"""

import numpy as np
import pytest
import torch

from ratelimiter_tpu.algorithms import (
    SlidingWindowLogRateLimiter as RefLog,
    SlidingWindowRateLimiter as RefSW,
    TokenBucketRateLimiter as RefTB,
)
from ratelimiter_tpu.core.config import RateLimitConfig as RefConfig
from ratelimiter_tpu.metrics import MeterRegistry as RefRegistry
from ratelimiter_tpu.storage.errors import (
    StorageException as RefStorageException,
)
from ratelimiter_tpu.storage.memory import InMemoryStorage as RefMemory
from ratelimiter_tpu.storage.tpu import TpuBatchedStorage
from ratelimiter_tpu_torch import RateLimitConfig
from ratelimiter_tpu_torch.algorithms import (
    SlidingWindowLogRateLimiter,
    SlidingWindowRateLimiter,
    TokenBucketRateLimiter,
)
from ratelimiter_tpu_torch.metrics import MeterRegistry
from ratelimiter_tpu_torch.ops.cuda import block_scatter, relay_step, solver
from ratelimiter_tpu_torch.storage import InMemoryStorage
from ratelimiter_tpu_torch.storage.errors import StorageException
from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage
from torch_reference_native import (  # noqa: F401 (autouse fixture)
    idle_reference_flushers,
    require_reference_native,
)

torch.set_num_threads(1)

T0 = 1_700_000_000_000
# Clock steps, ms: repeats at one stamp, small moves, TTL and window
# crossings, and one backward step (index 5).
STEPS = (0, 0, 3, 17, 250, -400, 999, 2_000, 61_000)


def _legacy_calls(rng, n: int, n_keys: int = 6):
    """(clock step, method, args) for ``n`` seeded legacy calls."""
    out = []
    for i in range(n):
        key = f"k{int(rng.integers(0, n_keys))}"
        op = int(rng.integers(0, 11))
        dt = int(rng.choice(STEPS[:-1]))
        if op == 0:
            call = ("increment_and_expire", key, int(rng.choice([5, 50, 500])))
        elif op == 1:
            call = ("get", key)
        elif op == 2:
            call = ("set", key, int(rng.integers(-3, 9)), 40)
        elif op == 3:
            call = ("compare_and_set", key, int(rng.integers(0, 3)),
                    int(rng.integers(0, 9)))
        elif op == 4:
            call = ("delete", key)
        elif op == 5:
            call = ("z_add", key, float(i), f"m{int(rng.integers(0, 20))}")
        elif op == 6:
            call = ("z_remove_range_by_score", key, float("-inf"),
                    float(i - 30))
        elif op == 7:
            call = ("z_count", key, float(i - 50), float("inf"))
        elif op == 8:
            call = ("eval_script", "token_bucket", [key],
                    [5 << 20, 3 << 10, int(rng.integers(1, 7)) << 20,
                     T0 + 10 * i, int(rng.choice([30, 3_000]))])
        elif op == 9:
            call = ("eval_script", "token_bucket_peek", [key],
                    [5 << 20, 3 << 10, T0 + 10 * i])
        else:
            call = ("eval_script", "lua", [key], [])
        out.append((dt, call))
    return out


def _drive_legacy(ref, port, clock, calls):
    for i, (dt, (name, *args)) in enumerate(calls):
        clock["t"] += dt
        try:
            want = getattr(ref, name)(*args)
        except RefStorageException as exc:
            want = ("raised", str(exc))
        try:
            got = getattr(port, name)(*args)
        except StorageException as exc:
            got = ("raised", str(exc))
        if isinstance(want, tuple) and want[:1] != ("raised",):
            want, got = tuple(want), tuple(got)
        assert got == want, (i, name, args, got, want)


def test_memory_storage_matches_reference():
    """Every legacy method of ``InMemoryStorage``, with TTL expiry,
    compare-and-set, zsets and both token-bucket scripts."""
    clock = {"t": T0}
    ref = RefMemory(clock_ms=lambda: clock["t"])
    port = InMemoryStorage(clock_ms=lambda: clock["t"])
    _drive_legacy(ref, port, clock,
                  _legacy_calls(np.random.default_rng(1), 1500))
    for side in (ref, port):
        side.set_available(False)
    assert port.is_available() == ref.is_available() is False


@pytest.mark.parametrize("host_parallel", [0, 4])
def test_device_storage_serves_the_legacy_contract(host_parallel):
    """``GpuBatchedStorage`` sends the ten methods to its embedded host
    store, as ``TpuBatchedStorage`` does, and launches no kernel."""
    require_reference_native()
    clock = {"t": T0}
    ref = TpuBatchedStorage(num_slots=1024, clock_ms=lambda: clock["t"],
                            host_parallel=host_parallel)
    port = GpuBatchedStorage(num_slots=1024, clock_ms=lambda: clock["t"],
                             device="cpu", host_parallel=host_parallel)
    before = (solver.launches, block_scatter.launches,
              relay_step.launches)
    try:
        _drive_legacy(ref, port, clock,
                      _legacy_calls(np.random.default_rng(2), 800))
        assert port.is_available() and ref.is_available()
    finally:
        ref.close()
        port.close()
    assert (solver.launches, block_scatter.launches,
            relay_step.launches) == before
    assert port.trace.snapshot()["total_dispatches"] == 0


def _log_pair(ref_storage, port_storage, clock, cfg_kw):
    now = lambda: clock["t"]  # noqa: E731
    return (RefLog(ref_storage, RefConfig(**cfg_kw), RefRegistry(),
                   clock_ms=now),
            SlidingWindowLogRateLimiter(port_storage,
                                        RateLimitConfig(**cfg_kw),
                                        MeterRegistry(), clock_ms=now))


def _drive_log(ref, port, clock, rng, n, cfg):
    for i in range(n):
        clock["t"] += int(rng.choice(STEPS))
        key = f"u{int(rng.integers(0, 8))}"
        if i % 61 == 60:
            ref.reset(key)
            port.reset(key)
            continue
        permits = int(rng.choice([1, 1, 2, 3, cfg["max_permits"],
                                  cfg["max_permits"] + 1]))
        assert (port.try_acquire(key, permits)
                == ref.try_acquire(key, permits)), (i, key, permits)
        if i % 5 == 0:
            assert (port.get_available_permits(key)
                    == ref.get_available_permits(key)), (i, key)
    for bad in (0, -1):
        with pytest.raises(ValueError):
            port.try_acquire("u0", bad)
        with pytest.raises(ValueError):
            ref.try_acquire("u0", bad)


@pytest.mark.parametrize("backend", ["memory", "device"])
def test_sliding_window_log_matches_reference(backend):
    """The exact sliding-window log over ``z_add`` /
    ``z_remove_range_by_score`` / ``z_count``, over a memory store and
    over the device storage's embedded one."""
    clock = {"t": T0}
    cfg = dict(max_permits=5, window_ms=1_000)
    made = []
    if backend == "memory":
        ref_st = RefMemory(clock_ms=lambda: clock["t"])
        port_st = InMemoryStorage(clock_ms=lambda: clock["t"])
    else:
        require_reference_native()
        ref_st = TpuBatchedStorage(num_slots=256, host_parallel=0,
                                   clock_ms=lambda: clock["t"])
        port_st = GpuBatchedStorage(num_slots=256, host_parallel=0,
                                    clock_ms=lambda: clock["t"],
                                    device="cpu")
        made = [ref_st, port_st]
    try:
        ref, port = _log_pair(ref_st, port_st, clock, cfg)
        _drive_log(ref, port, clock, np.random.default_rng(3), 900, cfg)
    finally:
        for st in made:
            st.close()


# The service's trio and two edge policies: a one-permit window and a
# bucket refilled at a fraction of a token per second.
COMPAT = {
    "api": ("sw", dict(max_permits=100, window_ms=60_000,
                       enable_local_cache=True, local_cache_ttl_ms=100)),
    "auth": ("sw", dict(max_permits=10, window_ms=60_000,
                        enable_local_cache=False)),
    "one": ("sw", dict(max_permits=1, window_ms=1_000,
                       enable_local_cache=False)),
    "burst": ("tb", dict(max_permits=50, window_ms=60_000,
                         refill_rate=10.0)),
    "slow": ("tb", dict(max_permits=3, window_ms=2_000, refill_rate=0.5)),
}


@pytest.mark.parametrize("seed", [0, 1])
def test_compat_limiters_match_reference(seed):
    """The sliding-window and token-bucket limiters over a storage that
    does not batch on the device: per-op counters (quirks Q1/Q2, the
    local negative cache) and the ``token_bucket`` scripts, decision for
    decision, with available permits, resets and the scalar
    ``try_acquire_many`` loop."""
    clock = {"t": T0}
    now = lambda: clock["t"]  # noqa: E731
    sides = []
    for mem, reg, conf, sw_cls, tb_cls in (
            (RefMemory, RefRegistry, RefConfig, RefSW, RefTB),
            (InMemoryStorage, MeterRegistry, RateLimitConfig,
             SlidingWindowRateLimiter, TokenBucketRateLimiter)):
        storage, registry = mem(clock_ms=now), reg()
        lims = {name: (sw_cls if algo == "sw" else tb_cls)(
            storage, conf(**kw), registry, clock_ms=now)
            for name, (algo, kw) in COMPAT.items()}
        sides.append((lims, registry))
    (ref, ref_reg), (port, port_reg) = sides
    rng = np.random.default_rng(seed)
    names = list(COMPAT)
    keys = [f"user{k}" for k in (rng.zipf(1.1, 3000) - 1) % 20]
    for i, key in enumerate(keys):
        clock["t"] += int(rng.choice(STEPS))
        name = names[i % len(names)]
        cap = COMPAT[name][1]["max_permits"]
        permits = int(rng.choice([1, 1, 2, cap, cap + 1]))
        if i % 113 == 112:
            port[name].reset(key)
            ref[name].reset(key)
            continue
        assert (port[name].try_acquire(key, permits)
                == ref[name].try_acquire(key, permits)), (i, name, key)
        if i % 9 == 0:
            assert (port[name].get_available_permits(key)
                    == ref[name].get_available_permits(key)), (i, name)
        if i % 200 == 0:
            many = keys[max(i - 30, 0):i + 1]
            perms = [int(p) for p in rng.integers(1, 4, len(many))]
            np.testing.assert_array_equal(
                port[name].try_acquire_many(many, perms),
                ref[name].try_acquire_many(many, perms))
    for name in ("ratelimiter.requests.allowed",
                 "ratelimiter.requests.rejected", "ratelimiter.cache.hits",
                 "ratelimiter.tokenbucket.allowed",
                 "ratelimiter.tokenbucket.rejected"):
        assert (port_reg.counter(name).count()
                == ref_reg.counter(name).count()), name
    for lims in (port, ref):
        with pytest.raises(NotImplementedError):
            lims["auth"].try_acquire_ids(np.arange(3))
        with pytest.raises(NotImplementedError):
            lims["burst"].try_acquire_stream_ids(np.arange(3))


class _NoStream:
    """A device-batching storage without ``acquire_stream_strs``: every
    other attribute is the wrapped storage's."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        if name == "acquire_stream_strs":
            raise AttributeError(name)
        return getattr(self._inner, name)


def test_large_call_without_string_streams_takes_the_batch():
    """From 2^15 keys the limiters stream strings only when the storage
    has ``acquire_stream_strs``; otherwise the call is one
    ``acquire_many`` batch, in both packages."""
    require_reference_native()
    clock = {"t": T0}
    now = lambda: clock["t"]  # noqa: E731
    ref_st = TpuBatchedStorage(num_slots=1 << 16, clock_ms=now,
                               observability=False, host_parallel=0)
    port_st = GpuBatchedStorage(num_slots=1 << 16, clock_ms=now,
                                device="cpu", host_parallel=0)
    try:
        cfg = dict(max_permits=2, window_ms=60_000, refill_rate=1.0)
        ref = RefTB(_NoStream(ref_st), RefConfig(**cfg), RefRegistry())
        port = TokenBucketRateLimiter(_NoStream(port_st),
                                      RateLimitConfig(**cfg),
                                      MeterRegistry())
        rng = np.random.default_rng(4)
        keys = [f"k{k}" for k in rng.integers(0, 20_000, 1 << 15)]
        np.testing.assert_array_equal(port.try_acquire_many(keys),
                                      ref.try_acquire_many(keys))
        # The batch route, not a stream: no stream chunk was recorded.
        assert port_st.last_stream_chunks == []
    finally:
        ref_st.close()
        port_st.close()
