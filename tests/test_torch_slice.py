"""The port's micro-batch route end to end against the JAX package's.

The same configs, keys, permits and clock go through ``TpuBatchedStorage``
with the reference limiters and through ``GpuBatchedStorage(device="cpu")``
with the port's limiters.  Every ``try_acquire`` result and every
available-permits value must be equal, and so must each key's packed state
row (compared per key: the two sides assign their own slot numbers).
Both storages keep their keys in the C slot index (``native/slot_index.cpp``).
"""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from ratelimiter_tpu.algorithms import (
    SlidingWindowRateLimiter as RefSW,
    TokenBucketRateLimiter as RefTB,
)
from ratelimiter_tpu.core.config import RateLimitConfig as RefConfig
from ratelimiter_tpu.metrics import MeterRegistry as RefRegistry
from ratelimiter_tpu.storage.tpu import TpuBatchedStorage
from ratelimiter_tpu_torch import RateLimitConfig
from ratelimiter_tpu_torch.algorithms import (
    SlidingWindowRateLimiter,
    TokenBucketRateLimiter,
)
from ratelimiter_tpu_torch.metrics import MeterRegistry
from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage
from torch_reference_native import idle_reference_flushers  # noqa: F401

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
# The service's api / auth / burst trio.
TRIO = {
    "api": ("sw", dict(max_permits=100, window_ms=60_000,
                       enable_local_cache=True, local_cache_ttl_ms=100)),
    "auth": ("sw", dict(max_permits=10, window_ms=60_000,
                        enable_local_cache=False)),
    "burst": ("tb", dict(max_permits=50, window_ms=60_000, refill_rate=10.0)),
}


class _Side:
    """One package's storage + limiter trio on a shared test clock, its
    host index over ``host_parallel`` partitions (0: one index)."""

    def __init__(self, ref: bool, clock, num_slots: int,
                 host_parallel: int = 0):
        self.ref = ref
        if ref:
            self.storage = TpuBatchedStorage(
                num_slots=num_slots, clock_ms=clock,
                observability=False, host_parallel=host_parallel)
            reg, cfg = RefRegistry(), RefConfig
        else:
            self.storage = GpuBatchedStorage(
                num_slots=num_slots, clock_ms=clock, device="cpu",
                host_parallel=host_parallel)
            reg, cfg = MeterRegistry(), RateLimitConfig
        self.limiters = {}
        for name, (algo, kw) in TRIO.items():
            if algo == "sw":
                cls = RefSW if ref else SlidingWindowRateLimiter
                self.limiters[name] = cls(self.storage, cfg(**kw), reg,
                                          clock_ms=clock)
            else:
                cls = RefTB if ref else TokenBucketRateLimiter
                self.limiters[name] = cls(self.storage, cfg(**kw), reg)

    def row(self, name, key):
        """The key's packed state row, or None when it holds no slot."""
        lim = self.limiters[name]
        algo = TRIO[name][0]
        slot = self.storage._index[algo].get((lim._lid, key))
        if slot is None:
            return None
        return self.storage.engine.read_rows(algo, [slot])[0]


@pytest.fixture
def sides():
    clock = {"t": 1_700_000_000_000}
    made = [_Side(True, lambda: clock["t"], 1024),
            _Side(False, lambda: clock["t"], 1024)]
    yield clock, made
    for side in made:
        side.storage.close()


def _keys(rng, n, n_keys):
    return [f"user{k}" for k in (rng.zipf(1.1, n) - 1) % n_keys]


def test_try_acquire_and_available_match_reference(sides):
    clock, (ref, port) = sides
    rng = np.random.default_rng(0)
    steps = rng.integers(0, 2_500, 240)
    steps[80] = 61_000           # crosses a window boundary
    steps[150] = -4_000          # the clock steps backward once
    keys = _keys(rng, 240, 30)
    for i, (dt, key) in enumerate(zip(steps, keys)):
        clock["t"] += int(dt)
        name = ("api", "auth", "burst")[i % 3]
        permits = int(rng.integers(1, 60)) if name == "burst" else \
            int(rng.integers(1, 4))
        got = port.limiters[name].try_acquire(key, permits)
        want = ref.limiters[name].try_acquire(key, permits)
        assert got == want, (i, name, key, permits)
        if i % 20 == 0:
            for k in set(keys[:i + 1][-5:]):
                assert (port.limiters[name].get_available_permits(k)
                        == ref.limiters[name].get_available_permits(k))
    assert port.storage.backward_clamps == ref.storage.backward_clamps > 0
    for name in TRIO:
        for key in set(keys):
            r, p = ref.row(name, key), port.row(name, key)
            assert (r is None) == (p is None)
            if r is not None:
                np.testing.assert_array_equal(p, r)


def test_bursts_evictions_resets_and_policy_updates_match(sides):
    """acquire_many bursts over more keys than slots (eviction churn),
    admin resets, and a live set_policy, through both packages."""
    clock, (ref, port) = sides
    rng = np.random.default_rng(1)
    for round_ in range(6):
        clock["t"] += int(rng.integers(0, 9_000))
        for name in TRIO:
            keys = ([f"fresh{round_}-{j}" for j in range(200)]
                    if round_ % 2 else _keys(rng, 200, 64))
            permits = rng.integers(1, 60 if name == "burst" else 3, 200)
            got = port.limiters[name].try_acquire_many(keys, permits)
            want = ref.limiters[name].try_acquire_many(keys, permits)
            np.testing.assert_array_equal(got, want)
        for name in TRIO:
            key = _keys(rng, 1, 64)[0]
            port.limiters[name].reset(key)
            ref.limiters[name].reset(key)
        if round_ == 2:
            for side, cfg in ((port, RateLimitConfig), (ref, RefConfig)):
                lim = side.limiters["burst"]
                side.storage.set_policy(lim._lid, cfg(
                    max_permits=20, window_ms=60_000, refill_rate=3.0))
        probe = _keys(rng, 8, 64)
        for name in TRIO:
            np.testing.assert_array_equal(
                port.limiters[name].available_permits_many(probe),
                ref.limiters[name].available_permits_many(probe))
    assert (port.storage.table.generation
            == ref.storage.table.generation == 1)


def test_burst_recency_matches_reference():
    """A key repeated in a burst counts as one recency touch at its first
    occurrence, as in the reference's batch assign: under eviction the
    same key loses its slot on both sides (a per-key assign loop would
    refresh the repeat and evict another key)."""
    clock = lambda: 1_700_000_000_000  # noqa: E731
    kw = dict(max_permits=2, window_ms=60_000, enable_local_cache=False)
    ref_st = TpuBatchedStorage(num_slots=8, clock_ms=clock,
                               observability=False, host_parallel=0)
    port_st = GpuBatchedStorage(num_slots=8, clock_ms=clock, device="cpu",
                                host_parallel=0)
    try:
        ref = RefSW(ref_st, RefConfig(**kw), RefRegistry(), clock_ms=clock)
        port = SlidingWindowRateLimiter(port_st, RateLimitConfig(**kw),
                                        MeterRegistry(), clock_ms=clock)
        for keys in (["a", "b", "a"], ["c", "d", "e", "f", "g", "h"], ["i"],
                     ["a", "b"]):
            np.testing.assert_array_equal(port.try_acquire_many(keys),
                                          ref.try_acquire_many(keys))
        # "a" was the least recent, so it was evicted and starts afresh.
        assert port.get_available_permits("a") == 1
    finally:
        ref_st.close()
        port_st.close()


def test_concurrent_try_acquire_loses_no_update():
    """A few submitting threads on one hot token bucket with the clock held
    still: exactly the capacity is admitted, whatever batches the flusher
    forms."""
    import threading

    storage = GpuBatchedStorage(num_slots=1024, clock_ms=lambda: 5_000_000,
                                device="cpu")
    lim = TokenBucketRateLimiter(storage, RateLimitConfig(
        max_permits=50, window_ms=60_000, refill_rate=1.0), MeterRegistry())
    allowed = []
    lock = threading.Lock()

    def worker():
        for _ in range(20):
            ok = lim.try_acquire("hot")
            with lock:
                allowed.append(ok)

    try:
        threads = [threading.Thread(target=worker) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        storage.close()
    assert len(allowed) == 60 and sum(allowed) == 50


def test_legacy_contract_is_not_served():
    """The ten legacy counter/zset/script methods go to the storage's
    embedded host store, as the reference's do: the same calls on the
    same clock give the same answers, exceptions included, through TTL
    expiry and both token-bucket scripts."""
    from ratelimiter_tpu.storage.errors import (
        StorageException as RefStorageException,
    )
    from ratelimiter_tpu_torch.storage.errors import StorageException

    clock = {"t": 1_700_000_000_000}
    ref = TpuBatchedStorage(num_slots=1024, clock_ms=lambda: clock["t"],
                            observability=False, host_parallel=0)
    port = GpuBatchedStorage(num_slots=1024, clock_ms=lambda: clock["t"],
                             device="cpu", host_parallel=0)
    rng = np.random.default_rng(5)
    calls = []
    for i in range(400):
        key = f"k{int(rng.integers(0, 6))}"
        op = int(rng.integers(0, 11))
        if op == 0:
            calls.append(("increment_and_expire", key, 50))
        elif op == 1:
            calls.append(("get", key))
        elif op == 2:
            calls.append(("set", key, int(rng.integers(0, 9)), 40))
        elif op == 3:
            calls.append(("compare_and_set", key, int(rng.integers(0, 3)),
                          int(rng.integers(0, 9))))
        elif op == 4:
            calls.append(("delete", key))
        elif op == 5:
            calls.append(("z_add", key, float(clock["t"] + i),
                          f"m{int(rng.integers(0, 20))}"))
        elif op == 6:
            calls.append(("z_remove_range_by_score", key, float("-inf"),
                          float(clock["t"] + i - 30)))
        elif op == 7:
            calls.append(("z_count", key, float(clock["t"]), float("inf")))
        elif op == 8:
            calls.append(("eval_script", "token_bucket", [key],
                          [5 << 20, 3 << 10, int(rng.integers(1, 3)) << 20,
                           clock["t"] + i, 60]))
        elif op == 9:
            calls.append(("eval_script", "token_bucket_peek", [key],
                          [5 << 20, 3 << 10, clock["t"] + i]))
        else:
            calls.append(("eval_script", "no_such_script", [key], []))
    try:
        for i, (name, *args) in enumerate(calls):
            clock["t"] += int(rng.integers(0, 12))
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
            assert got == want, (i, name, args)
        assert port.is_available() and ref.is_available()
    finally:
        ref.close()
        port.close()


def _port_modules():
    root = REPO / "ratelimiter_tpu_torch"
    return sorted(root.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_imports_no_jax():
    """Importing every module of the port pulls in neither jax nor the
    JAX package; no port file (nor chip_smoke.py) names them in an
    import."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import ratelimiter_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in mods:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib',\n"
        "                                    'ratelimiter_tpu'))\n"
        "assert not bad, bad\n"
        "print(' '.join(mods))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    mods = set(res.stdout.split())
    assert len(mods) >= 30
    # The token-lease tier, the durability modules, flat replication
    # with its control plane, the cross-host topology, the sidecar, the
    # edge process and the adaptive control plane are among the modules
    # imported.
    assert {f"ratelimiter_tpu_torch.{m}" for m in (
        "ops.lease", "leases.table", "leases.sublease", "leases.manager",
        "leases.client", "edge.aggregator", "engine.checkpoint",
        "engine.slots", "replication", "replication.wire",
        "replication.log", "replication.transport",
        "replication.replicator", "replication.standby",
        "replication.control", "replication.remote",
        "replication.orchestrator", "replication.hostproc",
        "service.sidecar", "edge.edgeproc", "control",
        "control.controller", "control.fleet")} <= mods
    for path in _port_modules():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in (
                    "jax", "jaxlib", "ratelimiter_tpu"), (path, name)


def test_storage_defaults_to_the_card(monkeypatch):
    """With no device asked for, the storage runs on CUDA or raises: it
    never moves to the CPU by itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        GpuBatchedStorage(num_slots=1024)


def test_limiters_need_a_device_batching_storage():
    """Over a storage that does not batch on the device the limiters take
    the reference's compat path (per-operation counter and script
    calls): the trio over the port's ``InMemoryStorage`` decides as the
    reference's trio over its own, call for call, with available-permits
    reads, resets and ``try_acquire_many``'s scalar loop."""
    from ratelimiter_tpu.storage.memory import InMemoryStorage as RefMemory
    from ratelimiter_tpu_torch.storage.memory import InMemoryStorage

    clock = {"t": 1_700_000_000_000}
    now = lambda: clock["t"]  # noqa: E731
    sides = []
    for mem, reg, conf, sw_cls, tb_cls in (
            (RefMemory, RefRegistry, RefConfig, RefSW, RefTB),
            (InMemoryStorage, MeterRegistry, RateLimitConfig,
             SlidingWindowRateLimiter, TokenBucketRateLimiter)):
        storage, registry = mem(clock_ms=now), reg()
        sides.append({name: (sw_cls if algo == "sw" else tb_cls)(
            storage, conf(**kw), registry, clock_ms=now)
            for name, (algo, kw) in TRIO.items()})
    ref, port = sides
    assert all(lim._lid is None for lim in port.values())
    rng = np.random.default_rng(9)
    keys = _keys(rng, 600, 12)
    for i, key in enumerate(keys):
        clock["t"] += int(rng.choice([0, 3, 40, 900, 20_000, 61_000]))
        name = ("api", "auth", "burst")[i % 3]
        permits = (int(rng.integers(1, 60)) if name == "burst"
                   else int(rng.integers(1, 4)))
        if i % 97 == 96:
            port[name].reset(key)
            ref[name].reset(key)
            continue
        assert (port[name].try_acquire(key, permits)
                == ref[name].try_acquire(key, permits)), (i, name, key)
        if i % 7 == 0:
            assert (port[name].get_available_permits(key)
                    == ref[name].get_available_permits(key)), (i, name)
        if i % 50 == 0:
            many = keys[max(i - 20, 0):i + 1]
            np.testing.assert_array_equal(
                port[name].try_acquire_many(many),
                ref[name].try_acquire_many(many))
