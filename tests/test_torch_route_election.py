"""The sharded streams' route election (``GpuBatchedStorage._route_sharded``)
against the JAX package's (``TpuBatchedStorage._route_sharded``).

Both packages' storages run over sharded engines of 2 and 4 shards (the
reference's on ``make_mesh``, the port's as CPU tensors) on one clock,
each with its own flight recorder, under ``RATELIMITER_DEVICE_ROUTE``
``on``, ``off`` and ``auto``:

- ``on`` / ``off`` fix the route (``device`` / ``host``) at the first
  chunk, and nothing is recorded;
- under ``auto`` a chunk below 2^16 requests leaves the route unset; the
  first chunk of 2^16 requests elects it once, recording
  ``sharded.route_elect`` with the reference's fields (``host_s``,
  ``device_s``, ``elected``, ``n``), and later chunks keep it;
- under each mode every decision (int and string keys) and both state
  tables equal the reference's.
"""

import numpy as np
import pytest
import torch

from ratelimiter_tpu.core.config import RateLimitConfig as RefConfig
from ratelimiter_tpu.engine.state import LimiterTable as RefTable
from ratelimiter_tpu.observability.flightrecorder import (
    FlightRecorder as RefRecorder,
)
from ratelimiter_tpu.parallel import ShardedDeviceEngine as RefEngine
from ratelimiter_tpu.parallel import make_mesh
from ratelimiter_tpu.storage.tpu import TpuBatchedStorage
from ratelimiter_tpu_torch import RateLimitConfig
from ratelimiter_tpu_torch.engine.state import LimiterTable
from ratelimiter_tpu_torch.observability.flightrecorder import FlightRecorder
from ratelimiter_tpu_torch.parallel import ShardedDeviceEngine
from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage
from torch_reference_native import (  # noqa: F401 (autouse fixture)
    idle_reference_flushers,
    require_reference_native,
)

torch.set_num_threads(1)

T0 = 1_700_000_000_000
SPS = 512
TB = dict(max_permits=20, window_ms=1000, refill_rate=5.0)
SW = dict(max_permits=15, window_ms=1000)
ELECT_N = 1 << 16
FIXED = {"on": "device", "off": "host", "auto": None}


class Pair:
    """A reference and a port storage over ``n``-shard engines, a flight
    recorder each, one clock, the token bucket and sliding window of
    :data:`TB` and :data:`SW` registered in both."""

    def __init__(self, n: int):
        require_reference_native()
        self.t = T0
        ref_t, port_t = RefTable(), LimiterTable(device="cpu")
        self.ref_rec, self.port_rec = RefRecorder(), FlightRecorder()
        self.ref = TpuBatchedStorage(
            engine=RefEngine(SPS, ref_t, mesh=make_mesh(n_devices=n)),
            clock_ms=self.now, recorder=self.ref_rec)
        self.port = GpuBatchedStorage(
            engine=ShardedDeviceEngine(SPS, port_t, devices=["cpu"] * n),
            clock_ms=self.now, recorder=self.port_rec)
        self.lids = {}
        for algo, cfg in (("tb", TB), ("sw", SW)):
            a = self.ref.register_limiter(algo, RefConfig(**cfg))
            assert self.port.register_limiter(
                algo, RateLimitConfig(**cfg)) == a
            self.lids[algo] = a

    def now(self) -> int:
        return self.t

    def call(self, dt, algo, keys, strs=False):
        self.t += dt
        name = "acquire_stream_strs" if strs else "acquire_stream_ids"
        want = getattr(self.ref, name)(algo, self.lids[algo], keys)
        got = getattr(self.port, name)(algo, self.lids[algo], keys)
        np.testing.assert_array_equal(got, want)
        assert 0 < got.sum() < len(keys)
        assert self.port._route_mode == self.ref._route_mode

    def elections(self):
        return (self.ref_rec.events(kind="sharded.route_elect"),
                self.port_rec.events(kind="sharded.route_elect"))

    def same_state(self):
        self.ref.flush()
        self.port.flush()
        for algo in ("sw", "tb"):
            want = np.asarray(getattr(self.ref.engine, f"{algo}_packed"))
            np.testing.assert_array_equal(
                self.port.engine.packed_host(algo),
                want.reshape(-1, want.shape[-1]), err_msg=algo)

    def close(self):
        self.ref.close()
        self.port.close()


def _zipf(rng, n, n_keys):
    return ((rng.zipf(1.1, n) - 1) % n_keys).astype(np.int64)


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("mode", ["on", "off", "auto"])
def test_route_election_matches_reference(mode, shards, monkeypatch):
    monkeypatch.setenv("RATELIMITER_DEVICE_ROUTE", mode)
    rng = np.random.default_rng(7 * shards + len(mode))
    pair = Pair(shards)
    try:
        pair.call(300, "tb", _zipf(rng, 2_000, 300))
        assert pair.port._route_mode == FIXED[mode]
        pair.call(300, "sw", [f"s{k}" for k in _zipf(rng, 2_000, 300)],
                  strs=True)
        assert pair.port._route_mode == FIXED[mode]
        pair.call(700, "tb", _zipf(rng, ELECT_N, 300))
        ref_ev, port_ev = pair.elections()
        if mode == "auto":
            assert pair.port._route_mode in ("host", "device")
            assert len(ref_ev) == len(port_ev) == 1
            for ev, st in ((ref_ev[0], pair.ref), (port_ev[0], pair.port)):
                assert set(ev) - {"seq", "t_ms", "kind"} == {
                    "host_s", "device_s", "elected", "n"}
                assert ev["n"] == ELECT_N
                assert ev["elected"] == st._route_mode
                assert ev["host_s"] >= 0 and ev["device_s"] >= 0
        else:
            assert pair.port._route_mode == FIXED[mode]
            assert ref_ev == port_ev == []
        elected = pair.port._route_mode
        pair.call(700, "sw", _zipf(rng, ELECT_N, 300))
        pair.call(300, "tb", [f"t{k}" for k in _zipf(rng, 3_000, 500)],
                  strs=True)
        assert pair.port._route_mode == elected
        assert [len(e) for e in pair.elections()] == [len(ref_ev)] * 2
        pair.same_state()
    finally:
        pair.close()


def test_forced_routes_bin_alike(monkeypatch):
    """The port's two routes on one chunk: equal shards, order, counts
    and gathered keys and fingerprints."""
    rng = np.random.default_rng(3)
    st = GpuBatchedStorage(
        engine=ShardedDeviceEngine(SPS, LimiterTable(device="cpu"),
                                   devices=["cpu"] * 4),
        clock_ms=lambda: T0, observability=False)
    try:
        keys = rng.integers(-(1 << 40), 1 << 40, 5_000)
        h1 = rng.integers(0, 1 << 63, 5_000).astype(np.uint64)
        h2 = rng.integers(0, 1 << 63, 5_000).astype(np.uint64)
        got = {}
        for mode in ("host", "device"):
            st._route_mode = mode
            got[mode] = (st._route_sharded(kchunk=keys),
                         st._route_sharded(h1=h1, h2=h2))
        for a, b in zip(*got.values()):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    finally:
        st.close()
