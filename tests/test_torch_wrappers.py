"""The storage as the service composes it, port against the JAX package:
``retry(breaker(chaos(storage)))`` with the degraded host limiter, the
outage drill, the policy surface and the storage's meters.

Both sides get the same seeded traffic, manual clock and fault schedule
(``fail_next``, or ``failure_rate`` with one seed), over
``GpuBatchedStorage(device="cpu")`` and ``TpuBatchedStorage`` with the
same explicit ``host_parallel``.  Decisions, exceptions, breaker states
and counts, the degraded limiter's touched set, ``policy_info()``, meter
counts and packed rows must be equal.  Retries sleep 0 ms.
"""

import numpy as np
import pytest
import torch

from ratelimiter_tpu.algorithms import (
    SlidingWindowRateLimiter as RefSW,
    TokenBucketRateLimiter as RefTB,
)
from ratelimiter_tpu.core.config import RateLimitConfig as RefConfig
from ratelimiter_tpu.metrics import MeterRegistry as RefRegistry
from ratelimiter_tpu.observability import FlightRecorder as RefRecorder
from ratelimiter_tpu.storage import (
    CircuitBreakerStorage as RefBreaker,
    DegradedHostLimiter as RefDegraded,
    FaultInjectingStorage as RefChaos,
    RetryingStorage as RefRetry,
)
from ratelimiter_tpu.storage.chaos import outage_drill as ref_outage_drill
from ratelimiter_tpu.storage.errors import (
    RetryPolicy as RefRetryPolicy,
    StorageException as RefStorageException,
)
from ratelimiter_tpu.storage.tpu import TpuBatchedStorage
from ratelimiter_tpu_torch import RateLimitConfig
from ratelimiter_tpu_torch.algorithms import (
    SlidingWindowRateLimiter,
    TokenBucketRateLimiter,
)
from ratelimiter_tpu_torch.metrics import MeterRegistry
from ratelimiter_tpu_torch.observability import FlightRecorder
from ratelimiter_tpu_torch.storage import (
    CircuitBreakerStorage,
    DegradedHostLimiter,
    FaultInjectingStorage,
    RetryingStorage,
)
from ratelimiter_tpu_torch.storage.chaos import outage_drill
from ratelimiter_tpu_torch.storage.errors import RetryPolicy, StorageException
from ratelimiter_tpu_torch.storage import gpu as gpu_module
from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage
from torch_reference_native import (  # noqa: F401 (autouse fixture)
    idle_reference_flushers,
    require_reference_native,
)

torch.set_num_threads(1)

T0 = 1_753_000_000_000
TRIO = {
    "api": ("sw", dict(max_permits=100, window_ms=60_000,
                       enable_local_cache=True, local_cache_ttl_ms=100)),
    "auth": ("sw", dict(max_permits=10, window_ms=60_000,
                        enable_local_cache=False)),
    "burst": ("tb", dict(max_permits=50, window_ms=60_000, refill_rate=10.0)),
}


class _Stack:
    """One package's ``retry(breaker(chaos(storage)))`` with the degraded
    fallback subscribed to policy updates, on a shared manual clock."""

    def __init__(self, ref: bool, clock, host_parallel: int,
                 num_slots: int = 1024, failure_rate: float = 0.0,
                 seed: int = 0, threshold: int = 4):
        now = lambda: clock["t"]  # noqa: E731
        if ref:
            self.registry = RefRegistry()
            self.storage = TpuBatchedStorage(
                num_slots=num_slots, clock_ms=now,
                host_parallel=host_parallel, meter_registry=self.registry)
            chaos, breaker, degraded, retry, policy = (
                RefChaos, RefBreaker, RefDegraded, RefRetry, RefRetryPolicy)
            self.recorder = RefRecorder()
            self.errors = (RefStorageException,)
        else:
            self.registry = MeterRegistry()
            self.storage = GpuBatchedStorage(
                num_slots=num_slots, clock_ms=now, device="cpu",
                host_parallel=host_parallel, meter_registry=self.registry)
            chaos, breaker, degraded, retry, policy = (
                FaultInjectingStorage, CircuitBreakerStorage,
                DegradedHostLimiter, RetryingStorage, RetryPolicy)
            self.recorder = FlightRecorder()
            self.errors = (StorageException,)
        self.chaos = chaos(self.storage, failure_rate=failure_rate,
                           seed=seed)
        self.fallback = degraded(clock_ms=now, registry=self.registry)
        self.storage.add_policy_listener(self.fallback.update_policy)
        self.breaker = breaker(self.chaos, failure_threshold=threshold,
                               open_ms=5_000, half_open_probes=1,
                               clock_ms=now, fallback=self.fallback,
                               registry=self.registry,
                               recorder=self.recorder)
        self.top = retry(self.breaker, policy(max_retries=3,
                                              retry_delay_ms=0.0))

    def call(self, name, *args):
        """A call's result, or the name of what it raised."""
        try:
            out = getattr(self.top, name)(*args)
        except self.errors as exc:
            return ("raised", type(exc).__name__, str(exc))
        except (ValueError, KeyError, TypeError) as exc:
            return ("raised", type(exc).__name__)
        if isinstance(out, dict):
            return {k: int(v) for k, v in out.items()}
        if isinstance(out, np.ndarray):
            return out.tolist()
        return out

    def state(self):
        st = self.breaker.status()
        return (st, self.fallback.touched(), self.chaos.injected_failures,
                list(self.chaos.calls))

    def row(self, algo, lid, key):
        slot = self.storage._index[algo].get((lid, key))
        if slot is None:
            return None
        return self.storage.engine.read_rows(algo, [slot])[0].tolist()

    def close(self):
        self.top.close()


def _pair(host_parallel, **kw):
    require_reference_native()
    clock = {"t": T0}
    return clock, _Stack(True, clock, host_parallel, **kw), \
        _Stack(False, clock, host_parallel, **kw)


def _events(recorder):
    return [e["kind"] for e in recorder.events(kind="breaker")]


@pytest.mark.parametrize("host_parallel", [0, 4])
def test_breaker_outage_and_resync_match_reference(host_parallel):
    """Healthy decisions, a sustained outage (breaker opens after
    ceil(threshold / attempts) requests, degraded decisions touch no
    backend, admin reads and resets go to the fallback), a live policy
    update heard by the fallback, heal, a half-open probe, the resync's
    device resets, and post-resync decisions: equal on both sides, down to
    the packed rows of every key."""
    clock, ref, port = _pair(host_parallel)
    try:
        lids = {}
        for side in (ref, port):
            lids[id(side)] = (side.top.register_limiter(
                "sw", (RefConfig if side is ref else RateLimitConfig)(
                    max_permits=6, window_ms=2_000)),
                side.top.register_limiter(
                "tb", (RefConfig if side is ref else RateLimitConfig)(
                    max_permits=9, window_ms=2_000, refill_rate=3.0)))
        assert lids[id(ref)] == lids[id(port)]
        sw, tb = lids[id(port)]
        rng = np.random.default_rng(host_parallel + 11)
        keys = [f"u{k}" for k in range(12)]

        def both(name, *args):
            got, want = port.call(name, *args), ref.call(name, *args)
            assert got == want, (name, args, got, want)
            return got

        def wave(n):
            clock["t"] += int(rng.choice([0, 3, 17, 250, 999, 2_000]))
            for _ in range(n):
                key = keys[int(rng.integers(0, len(keys)))]
                permits = int(rng.choice([1, 1, 2, 5, 9, 10]))
                both("acquire", "sw", sw, key, permits)
                both("acquire", "tb", tb, key, permits)

        for _ in range(3):
            wave(20)
        both("available_many", "tb", tb, keys[:4])
        # A caller error neither counts toward opening nor converts.
        both("acquire", "xx", sw, "k", 1)
        assert port.breaker.status()["consecutive_failures"] == 0
        assert port.state() == ref.state()

        # Sustained outage: every backend op fails.
        for side in (ref, port):
            side.chaos.fail_next(1_000_000)
        for i in range(3):
            both("acquire", "sw", sw, keys[i], 1)
        assert port.breaker.state == ref.breaker.state == "open"
        calls_at_open = len(port.chaos.calls)
        for _ in range(3):
            wave(20)
        both("available_many", "sw", sw, keys[:6])
        both("reset_key", "tb", tb, keys[2])
        both("acquire_many", "sw", [sw, sw], keys[:2], [1, 1])
        # A live policy update while open: the fallback hears it.
        for side in (ref, port):
            side.storage.set_policy(tb, (RefConfig if side is ref
                                         else RateLimitConfig)(
                max_permits=4, window_ms=2_000, refill_rate=1.0))
        wave(10)
        assert len(port.chaos.calls) == calls_at_open
        assert port.state() == ref.state()
        assert port.fallback.touched()

        # Recovery: heal, pass the open window, probe, resync.
        for side in (ref, port):
            side.chaos.heal()
        clock["t"] += 5_001
        both("acquire", "sw", sw, "__probe__", 1)
        assert port.breaker.state == ref.breaker.state == "closed"
        assert port.breaker.resyncs_total == ref.breaker.resyncs_total == 1
        assert port.fallback.touched() == []
        assert _events(port.recorder) == _events(ref.recorder) == [
            "breaker.open", "breaker.half_open", "breaker.close",
            "breaker.resync"]
        for algo, lid in (("sw", sw), ("tb", tb)):
            for key in keys + ["__probe__"]:
                assert port.row(algo, lid, key) == ref.row(algo, lid, key)
        for _ in range(3):
            wave(20)
        assert port.state() == ref.state()
        assert (port.storage.policy_info() == ref.storage.policy_info())
        for name in ("ratelimiter.breaker.opened",
                     "ratelimiter.breaker.short_circuited",
                     "ratelimiter.degraded.decisions"):
            assert (port.registry.counter(name).count()
                    == ref.registry.counter(name).count()), name
        assert (port.registry.gauge("ratelimiter.breaker.state").value()
                == ref.registry.gauge("ratelimiter.breaker.state").value())
    finally:
        ref.close()
        port.close()


@pytest.mark.parametrize("host_parallel", [0, 4])
def test_flapping_backend_matches_reference(host_parallel):
    """A backend failing at random (one seeded rate on both sides) under
    the trio's limiters through the whole stack: retries absorb most
    faults, exhausted ones surface as ``StorageException``, the breaker
    opens and probes as the failures fall; every result, exception and
    transition equal."""
    clock, ref, port = _pair(host_parallel, failure_rate=0.45, seed=3,
                             threshold=6)
    try:
        lims = []
        for side, conf, sw_cls, tb_cls, reg in (
                (ref, RefConfig, RefSW, RefTB, RefRegistry),
                (port, RateLimitConfig, SlidingWindowRateLimiter,
                 TokenBucketRateLimiter, MeterRegistry)):
            now = lambda: clock["t"]  # noqa: E731
            lims.append({name: (sw_cls if algo == "sw" else tb_cls)(
                side.top, conf(**kw), reg(), clock_ms=now)
                for name, (algo, kw) in TRIO.items()})
        ref_l, port_l = lims
        # The wrappers pass the device-batching surface through.
        assert all(lim._lid is not None for lim in port_l.values())
        rng = np.random.default_rng(host_parallel)
        names = list(TRIO)
        for i in range(600):
            clock["t"] += int(rng.choice([0, 2, 40, 700, 3_000]))
            name = names[i % 3]
            key = f"user{int(rng.zipf(1.1)) % 40}"
            permits = int(rng.integers(1, 60)) if name == "burst" else 1
            outs = []
            for side_l, exc in ((port_l, StorageException),
                                (ref_l, RefStorageException)):
                try:
                    outs.append(side_l[name].try_acquire(key, permits))
                except exc as e:
                    outs.append(("raised", str(e)))
            assert outs[0] == outs[1], (i, name, key, outs)
            assert port.breaker.state == ref.breaker.state, i
        assert port.state() == ref.state()
        assert port.breaker.opened_total > 0
    finally:
        ref.close()
        port.close()


@pytest.mark.parametrize("host_parallel", [0, 4])
def test_batch_and_stream_ops_pass_through_unretried(host_parallel):
    """``RetryingStorage`` retries single decisions but passes batches
    and streams through: one injected fault fails an ``acquire_many``
    outright on both sides.  A 2^15-key ``try_acquire_many`` through the
    stack still reaches ``acquire_stream_strs``."""
    clock, ref, port = _pair(host_parallel, threshold=100)
    try:
        outs = []
        for side, conf, cls in ((ref, RefConfig, RefSW),
                                (port, RateLimitConfig,
                                 SlidingWindowRateLimiter)):
            lim = cls(side.top, conf(max_permits=3, window_ms=60_000,
                                     enable_local_cache=False),
                      MeterRegistry() if side is port else RefRegistry(),
                      clock_ms=lambda: clock["t"])
            side.chaos.fail_next(1)
            one = side.call("acquire", "sw", lim._lid, "a", 1)
            side.chaos.fail_next(1)
            many = side.call("acquire_many", "sw", [lim._lid] * 2,
                             ["a", "b"], [1, 1])
            side.chaos.fail_next(1)
            stream = side.call("acquire_stream_ids", "sw", lim._lid,
                               np.arange(5, dtype=np.int64))
            keys = [f"k{k}" for k in
                    np.random.default_rng(1).integers(0, 600, 1 << 15)]
            big = lim.try_acquire_many(keys).tolist()
            outs.append((one, many, stream, big,
                         side.chaos.injected_failures))
        assert outs[0] == outs[1]
        assert outs[1][1][0] == "raised" and outs[1][2][0] == "raised"
        assert port.storage.last_stream_chunks  # the string stream ran
    finally:
        ref.close()
        port.close()


def _cpu_storages(made, host_parallel=None):
    """A drill storage factory: ``GpuBatchedStorage`` on the CPU (with
    ``host_parallel`` pinned when given), each one kept in ``made``."""
    def factory(num_slots, clock_ms):
        made.append(GpuBatchedStorage(num_slots, clock_ms=clock_ms,
                                      device="cpu",
                                      host_parallel=host_parallel))
        return made[-1]
    return factory


@pytest.mark.parametrize("seed", [0, 1])
def test_outage_drill_matches_reference(seed, monkeypatch):
    """``outage_drill`` small on both packages (512 slots, the elected
    single index), over the storage it builds itself (moved to the CPU
    here): equal reports, each proving its claims."""
    require_reference_native()
    monkeypatch.setattr(gpu_module, "resolve_device",
                        lambda device: torch.device("cpu"))
    want = ref_outage_drill(seed=seed)
    got = outage_drill(seed=seed)
    assert got == want
    assert got["mismatches"] == 0 and got["shorted_backend_calls"] == 0
    assert got["touched_keys"] > 0


def test_outage_drill_takes_a_storage_factory():
    """The drill runs over the storage its factory builds (here on 4
    partitions; the chip smoke counts the resync's device clears through
    one), with the reference's report."""
    require_reference_native()
    made = []
    got = outage_drill(seed=2, num_slots=1024,
                       storage_factory=_cpu_storages(made, 4))
    assert len(made) == 1 and made[0]._host_parallel == 4
    assert got == ref_outage_drill(seed=2, num_slots=1024)


def test_policy_listeners_and_info_match_reference():
    """``add_policy_listener`` hears every ``set_policy`` after the row
    moved, with the generation it installed; a listener that raises does
    not stop the update; ``policy_info`` is equal."""
    clock, ref, port = _pair(0)
    try:
        heard = {"ref": [], "port": []}
        for side, tag, conf in ((ref, "ref", RefConfig),
                                (port, "port", RateLimitConfig)):
            st = side.storage
            st.add_policy_listener(lambda *a, t=tag: heard[t].append(
                (a[0], a[1], a[2].max_permits, a[3])))

            def broken(*_a):
                raise RuntimeError("mirror failed")
            st.add_policy_listener(broken)
            a = st.register_limiter("sw", conf(max_permits=5,
                                               window_ms=1_000))
            b = st.register_limiter("tb", conf(max_permits=7,
                                               window_ms=1_000,
                                               refill_rate=2.0))
            st.set_policy(b, conf(max_permits=3, window_ms=1_000,
                                  refill_rate=1.0))
            st.set_policy(a, conf(max_permits=8, window_ms=1_000))
            with pytest.raises(KeyError):
                st.set_policy(99, conf(max_permits=1, window_ms=1_000))
        assert heard["port"] == heard["ref"] and len(heard["port"]) == 2
        assert port.storage.policy_info() == ref.storage.policy_info()
    finally:
        ref.close()
        port.close()


STAGES = ("route", "pack", "index", "layout", "enqueue", "fetch")


@pytest.mark.parametrize("host_parallel", [0, 4])
def test_storage_meters_match_reference(host_parallel):
    """The storage's meters on the same calls: the latency timer's and
    each stream stage timer's record counts, the backward-clamp counter
    (equal to ``backward_clamps``), and the decision trace's records
    (algo, batch, allowed, route) — over single acquires, a batch, and
    streams of every route (relay digest and words, resident digest, the
    weighted relay's coalesced and rank-major modes, flat and scan, and
    string keys)."""
    require_reference_native()
    clock = {"t": T0}
    now = lambda: clock["t"]  # noqa: E731
    regs = (RefRegistry(), MeterRegistry())
    ref = TpuBatchedStorage(num_slots=4096, clock_ms=now,
                            host_parallel=host_parallel,
                            meter_registry=regs[0])
    port = GpuBatchedStorage(num_slots=4096, clock_ms=now, device="cpu",
                             host_parallel=host_parallel,
                             meter_registry=regs[1])
    try:
        rng = np.random.default_rng(host_parallel + 5)
        lids = []
        for st, conf in ((ref, RefConfig), (port, RateLimitConfig)):
            lids.append([
                st.register_limiter("sw", conf(max_permits=20,
                                               window_ms=1_000)),
                st.register_limiter("tb", conf(max_permits=30,
                                               window_ms=1_000,
                                               refill_rate=5.0)),
                st.register_limiter("tb", conf(max_permits=12,
                                               window_ms=1_000,
                                               refill_rate=2.0))])
        assert lids[0] == lids[1]
        sw, tb, tb2 = lids[1]
        keys = (rng.zipf(1.2, 3000) - 1) % 700
        calls = [
            ("acquire", "sw", sw, "a", 1), ("acquire", "tb", tb, "a", 3),
            ("acquire_many", "tb", [tb] * 5, ["a", "b", "a", "c", "d"],
             [1, 2, 3, 4, 5]),
            ("acquire_stream_ids", "tb", tb, keys[:2000]),
            ("acquire_stream_ids", "sw", sw, np.arange(3000) * 7 % 4000),
            ("acquire_stream_ids", "tb", tb, keys[:1500],
             (keys[:1500] % 9 + 1)),
            ("acquire_stream_ids", "tb", tb, np.arange(1500) * 13 % 600,
             rng.integers(1, 30, 1500)),
            ("acquire_stream_ids", "tb", tb, keys[:900],
             rng.integers(1, 400, 900), {"batch": 128, "subbatches": 2}),
            ("acquire_stream_ids", "tb", np.where(keys[:1200] % 2, tb, tb2),
             keys[:1200]),
            ("acquire_stream_ids", "tb", np.where(keys[:1000] % 3, tb, tb2),
             keys[:1000], rng.integers(1, 9, 1000)),
            ("acquire_stream_strs", "sw", sw,
             [f"s{k}" for k in keys[:2500]]),
            ("acquire_stream_strs", "tb", tb,
             [f"s{k}" for k in keys[:800]], rng.integers(1, 200, 800),
             {"batch": 256, "subbatches": 2}),
        ]
        for i, (name, *args) in enumerate(calls):
            clock["t"] += (-300 if i == 5 else 211)
            kw = args.pop() if isinstance(args[-1], dict) else {}
            got = getattr(port, name)(*args, **kw)
            want = getattr(ref, name)(*args, **kw)
            if isinstance(want, dict):
                got, want = got["allowed"], want["allowed"]
            np.testing.assert_array_equal(np.asarray(got),
                                          np.asarray(want), err_msg=name)
        port.flush()
        ref.flush()

        def timer(reg, name):
            return reg.timer(name).count()
        assert (timer(regs[1], "ratelimiter.storage.latency")
                == timer(regs[0], "ratelimiter.storage.latency"))
        for st in STAGES:
            name = f"ratelimiter.stream.{st}"
            assert timer(regs[1], name) == timer(regs[0], name), name
        assert timer(regs[1], "ratelimiter.stream.fetch") > 0
        assert (regs[1].counter("ratelimiter.time.backward_clamp").count()
                == port.backward_clamps == ref.backward_clamps > 0)

        def trace(st):
            snap = st.trace.snapshot(last=4096)
            return snap["total_dispatches"], sorted(
                (r["algo"], r["batch"], r["allowed"], r["path"])
                for r in snap["recent"])
        assert trace(port) == trace(ref)
    finally:
        ref.close()
        port.close()


def test_meters_off_with_observability_off():
    """``observability=False`` registers no storage meter and records no
    trace, as in the reference."""
    reg = MeterRegistry()
    port = GpuBatchedStorage(num_slots=256, device="cpu", host_parallel=0,
                             meter_registry=reg, observability=False)
    try:
        lid = port.register_limiter("sw", RateLimitConfig(max_permits=2,
                                                          window_ms=1_000))
        port.acquire("sw", lid, "k", 1)
        port.acquire_stream_ids("sw", lid, np.arange(10, dtype=np.int64))
        names = set(reg.meters())
        assert not any(n.startswith(("ratelimiter.storage.",
                                     "ratelimiter.stream."))
                       for n in names)
        assert port.trace.snapshot()["total_dispatches"] == 0
    finally:
        port.close()
