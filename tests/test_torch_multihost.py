"""The port's multi-host router (``ratelimiter_tpu_torch/parallel/
multihost.py``) over the port's decision sidecars, as
``tests/test_multihost.py`` checks the reference's: keys pinned to hosts
by hash (the reference's ``host_of_key``), a batch split by owner and
reassembled in order with every decision equal to the oracle, resets
routed to the owner, and a down endpoint surfaced to the caller while the
live host keeps serving.  One host's storage is sharded (two CPU shards),
the other flat.  Sockets are port 0 on loopback.
"""

import socket

import numpy as np
import pytest
import torch

from ratelimiter_tpu.parallel.multihost import host_of_key as ref_host_of_key
from ratelimiter_tpu_torch import RateLimitConfig
from ratelimiter_tpu_torch.engine.state import LimiterTable
from ratelimiter_tpu_torch.parallel import ShardedDeviceEngine
from ratelimiter_tpu_torch.parallel.multihost import HostRouter, host_of_key
from ratelimiter_tpu_torch.semantics.oracle import SlidingWindowOracle
from ratelimiter_tpu_torch.service.sidecar import SidecarServer
from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage
from torch_reference_native import idle_reference_flushers  # noqa: F401

torch.set_num_threads(1)

T0 = 1_753_000_020_000
CFG = dict(max_permits=4, window_ms=60_000, enable_local_cache=False)


def _host(clock, sharded: bool):
    if sharded:
        storage = GpuBatchedStorage(
            engine=ShardedDeviceEngine(128, LimiterTable(device="cpu"),
                                       devices=["cpu", "cpu"]),
            max_delay_ms=0.2, clock_ms=clock)
    else:
        storage = GpuBatchedStorage(num_slots=256, max_delay_ms=0.2,
                                    clock_ms=clock, device="cpu",
                                    host_parallel=0)
    server = SidecarServer(storage, host="127.0.0.1").start()
    lid = server.register("sw", RateLimitConfig(**CFG))
    return server, storage, lid


def _dead_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_host_hash_matches_reference():
    for n in (1, 2, 3, 5):
        for i in range(200):
            key = f"user{i}"
            assert host_of_key(key, n) == ref_host_of_key(key, n)


def test_router_splits_and_reassembles():
    clock = lambda: T0  # noqa: E731 — one window for the whole test
    hosts = [_host(clock, sharded) for sharded in (True, False)]
    router = HostRouter([("127.0.0.1", h[0].port) for h in hosts])
    try:
        lid = hosts[0][2]
        assert all(h[2] == lid for h in hosts)
        keys = [f"user{i}" for i in range(16)]
        assert {host_of_key(k, 2) for k in keys} == {0, 1}
        oracle = SlidingWindowOracle(RateLimitConfig(**CFG))
        rng = np.random.default_rng(3)
        for step in range(8):
            batch = [keys[int(i)] for i in rng.integers(0, 16, 20)]
            got = router.acquire_batch(lid, batch)
            assert got == [oracle.try_acquire(k, 1, T0).allowed
                           for k in batch], step
        victim = keys[0]
        while router.try_acquire(lid, victim):
            oracle.try_acquire(victim, 1, T0)
        router.reset(lid, victim)
        oracle.reset(victim, T0)
        assert router.available(lid, victim) == CFG["max_permits"]
        assert router.try_acquire(lid, victim)
    finally:
        router.close()
        for server, storage, _ in hosts:
            server.stop()
            storage.close()


def test_router_surfaces_down_endpoint():
    clock = lambda: T0  # noqa: E731
    server, storage, lid = _host(clock, sharded=True)
    router = HostRouter([("127.0.0.1", server.port),
                         ("127.0.0.1", _dead_port())])
    try:
        keys = [f"user{i}" for i in range(20)]
        up = [k for k in keys if host_of_key(k, 2) == 0]
        down = [k for k in keys if host_of_key(k, 2) == 1]
        assert up and down
        assert router.try_acquire(lid, up[0])
        with pytest.raises(OSError):
            router.try_acquire(lid, down[0])
        assert router.acquire_batch(lid, up[:3]) == [True] * 3
        with pytest.raises(OSError):
            router.acquire_batch(lid, keys)
        assert router.try_acquire(lid, up[1])  # the live host still serves
    finally:
        router.close()
        server.stop()
        storage.close()
