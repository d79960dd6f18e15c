"""The port's per-chunk stream records (``GpuBatchedStorage.stream_stats``)
against the JAX package's (``TpuBatchedStorage.stream_stats``).

The same seeded traffic goes through both packages' storages on one
clock, on the CPU, with ``stream_stats = []`` on each, profile-less and
with the same ``host_parallel``: the relay (digest and words chunks, int
and string keys), the weighted stream (rank-major, coalesced and flat
fallback chunks), the flat stream and its K-step scan, and the sharded
relay on 2 shards.  Decisions are equal; the records' sequence of
(``path``, ``mode``, ``n``, ``u``) is equal; each port record has the
reference record's keys and, but on the sharded relay, the port's own
fields (``gpu.PORT_CHUNK_FIELDS``: the assign's exposed wait, and of
string keys the hashing and its key packing), and every timing key
(``*_s``) holds a non-negative float (a list of them for the per-shard
ones).  With ``stream_stats`` None nothing is recorded.
"""

import numpy as np
import pytest
import torch

from ratelimiter_tpu.core.config import RateLimitConfig as RefConfig
from ratelimiter_tpu.engine.state import LimiterTable as RefTable
from ratelimiter_tpu.parallel import ShardedDeviceEngine as RefShardedEngine
from ratelimiter_tpu.parallel import make_mesh
from ratelimiter_tpu.storage import tpu as ref_storage_mod
from ratelimiter_tpu.storage.tpu import TpuBatchedStorage
from ratelimiter_tpu_torch import RateLimitConfig
from ratelimiter_tpu_torch.engine.state import LimiterTable
from ratelimiter_tpu_torch.parallel import ShardedDeviceEngine
from ratelimiter_tpu_torch.storage import gpu as gpu_mod
from ratelimiter_tpu_torch.storage.gpu import (
    PORT_CHUNK_FIELDS,
    GpuBatchedStorage,
)
from torch_reference_native import (  # noqa: F401 (autouse fixture)
    idle_reference_flushers,
    require_reference_native,
)

torch.set_num_threads(1)

T0 = 1_700_000_000_000
CFG = {"tb": dict(max_permits=30, window_ms=2_000, refill_rate=10.0),
       "sw": dict(max_permits=40, window_ms=2_000,
                  enable_local_cache=False)}


def _zipf(rng, n, n_keys):
    return ((rng.zipf(1.1, n) - 1) % n_keys).astype(np.int64)


def same_records(want: list, got: list, strs: bool = False) -> None:
    """The port's records against the reference's, chunk by chunk: the
    reference's keys, and but on the sharded relay the port's own fields
    (the hashing's of string keys only), each a non-negative float."""
    key = [(r["path"], r.get("mode"), r["n"], r.get("u")) for r in want]
    assert [(r["path"], r.get("mode"), r["n"], r.get("u"))
            for r in got] == key
    for w, g in zip(want, got):
        own = set()
        if g["path"] != "relay_sharded":
            own = {f for f in PORT_CHUNK_FIELDS
                   if strs or f == "assign_wait_s"}
        assert set(g) == set(w) | own, (w, g)
        for k in own:
            assert isinstance(g[k], float) and g[k] >= 0, (k, g[k])
        for k, v in w.items():
            if not k.endswith("_s"):
                continue
            if isinstance(v, list):
                assert len(g[k]) == len(v), k
                assert all(isinstance(x, float) and x >= 0 for x in g[k]), k
            else:
                assert isinstance(g[k], float) and g[k] >= 0, (k, g[k])
        if "fetch_at" in w:
            a, b = g["fetch_at"]
            assert 0 <= a <= b
        assert g["wire_bytes"] > 0


class Pair:
    """A reference and a port storage on one clock, the same limiter in
    both, the same ``host_parallel``; or, given ``shards``, both over
    sharded engines of that many shards (``slots`` a shard)."""

    def __init__(self, algo, host_parallel=0, slots=4096, shards=0):
        require_reference_native()
        self.algo = algo
        self.t = T0
        if shards:
            ref_t, port_t = RefTable(), LimiterTable(device="cpu")
            ref_e = RefShardedEngine(slots, ref_t,
                                     mesh=make_mesh(n_devices=shards))
            port_e = ShardedDeviceEngine(slots, port_t,
                                         devices=["cpu"] * shards)
            self.ref = TpuBatchedStorage(engine=ref_e, clock_ms=self.now,
                                         observability=False)
            self.port = GpuBatchedStorage(engine=port_e, clock_ms=self.now)
        else:
            self.ref = TpuBatchedStorage(num_slots=slots, clock_ms=self.now,
                                         observability=False,
                                         host_parallel=host_parallel)
            self.port = GpuBatchedStorage(num_slots=slots, clock_ms=self.now,
                                          device="cpu",
                                          host_parallel=host_parallel)
        self.lid = self.ref.register_limiter(algo, RefConfig(**CFG[algo]))
        assert self.port.register_limiter(
            algo, RateLimitConfig(**CFG[algo])) == self.lid

    def now(self) -> int:
        return self.t

    def call(self, dt, keys, permits=None, strs=False, **kw):
        """One stream call on both storages with ``stream_stats = []``:
        equal decisions and records; returns the port's records."""
        self.t += dt
        stats = []
        for st in (self.ref, self.port):
            st.stream_stats = []
            fn = st.acquire_stream_strs if strs else st.acquire_stream_ids
            stats.append((fn(self.algo, self.lid, keys, permits, **kw),
                          st.stream_stats))
            st.stream_stats = None
        (want, ref_recs), (got, port_recs) = stats
        np.testing.assert_array_equal(got, want)
        assert 0 < got.sum() < len(keys)
        same_records(ref_recs, port_recs, strs)
        assert len(port_recs) == len(self.port.last_stream_chunks)
        return port_recs

    def close(self):
        self.ref.close()
        self.port.close()


@pytest.fixture
def small_chunks(monkeypatch):
    """Relay chunks of 256 requests growing to 1024 at most, and flat
    steps of at most 512 lanes, in both storages."""
    for mod in (ref_storage_mod, gpu_mod):
        monkeypatch.setattr(mod, "_RELAY_CHUNK", 256)
        monkeypatch.setattr(mod, "_RELAY_CHUNK_MAX", 1024)
        monkeypatch.setattr(mod, "_FLAT_MAX_LANES", 512)


@pytest.mark.parametrize("host_parallel", [0, 4])
@pytest.mark.parametrize("algo", ["tb", "sw"])
def test_relay_records_match_reference(algo, host_parallel, small_chunks):
    """Unit permits: Zipf keys (digest chunks) and uniform keys over more
    keys than slots (words chunks, evicting), int keys and then string
    keys (the hashing as ``pack_s`` on one index, ``host_parallel`` on
    partitions)."""
    rng = np.random.default_rng(5 if algo == "tb" else 6)
    pair = Pair(algo, host_parallel, slots=1024)
    try:
        for rnd in range(2):
            recs = pair.call(700, _zipf(rng, 3_000, 300))
            assert {r["mode"] for r in recs} == {"digest"}
            keys = rng.permutation(np.concatenate([
                rng.integers(0, 5_000, 1_940), np.full(60, 9_999)]))
            recs = pair.call(900, keys)
            assert {r["mode"] for r in recs} == {"bits"}
            assert all(r.get("host_parallel", 0) == host_parallel
                       for r in recs)
            keys = [f"k{k}" for k in _zipf(rng, 2_000, 300)]
            recs = pair.call(700, keys, strs=True)
            assert ("pack_s" in recs[0]) == (host_parallel == 0)
        walks = [r["walk_s"] for r in recs]
        assert walks == sorted(walks)
    finally:
        pair.close()


@pytest.mark.parametrize("algo", ["tb", "sw"])
def test_weighted_records_match_reference(algo, monkeypatch):
    """Permits in [1, 45], one chunk a call: rank-major, coalesced and
    flat fallback chunks (a key past 64 repeats; flat steps of 512)."""
    for mod in (ref_storage_mod, gpu_mod):
        monkeypatch.setattr(mod, "_FLAT_MAX_LANES", 512)
    rng = np.random.default_rng(15 if algo == "tb" else 16)
    pair = Pair(algo)
    try:
        keys = rng.integers(0, 3_000, 2_000)
        recs = pair.call(700, keys, rng.integers(1, 46, 2_000))
        assert [r["mode"] for r in recs] == ["weighted"]
        keys = _zipf(rng, 3_000, 300)
        recs = pair.call(900, keys, 1 + keys % 45)
        assert [r["mode"] for r in recs] == ["weighted_coal"]
        keys = _zipf(rng, 3_000, 300)
        recs = pair.call(1_300, keys, rng.integers(1, 46, 3_000))
        assert [(r["path"], r["mode"]) for r in recs] == [
            ("relay_w", "flat_fb")]
    finally:
        pair.close()


@pytest.mark.parametrize("algo", ["tb", "sw"])
def test_flat_and_scan_records_match_reference(algo, small_chunks):
    """Permits past the weighted cap: super-batches of 384 requests (flat
    steps) and of 8 x 256 (K-step scans of 512-lane steps, the tail with
    fewer)."""
    rng = np.random.default_rng(25 if algo == "tb" else 26)
    pair = Pair(algo)
    try:
        keys = _zipf(rng, 1_000, 500)
        recs = pair.call(600, keys, rng.integers(1, 300, 1_000),
                         batch=128, subbatches=3)
        assert [r["mode"] for r in recs] == ["flat"] * 3
        keys = _zipf(rng, 3_000, 500)
        recs = pair.call(800, keys, rng.integers(1, 300, 3_000),
                         batch=256, subbatches=8)
        assert [r["mode"] for r in recs] == ["scan", "scan"]
        assert all("u" not in r for r in recs)
    finally:
        pair.close()


@pytest.mark.parametrize("algo", ["tb", "sw"])
def test_sharded_relay_records_match_reference(algo, small_chunks):
    """Unit permits on 2 shards of 512 slots: Zipf keys (digest shards)
    and uniform keys past the slots (words shards), several chunks."""
    rng = np.random.default_rng(35 if algo == "tb" else 36)
    pair = Pair(algo, slots=512, shards=2)
    try:
        recs = pair.call(700, _zipf(rng, 3_000, 300))
        assert {r["path"] for r in recs} == {"relay_sharded"}
        keys = rng.permutation(np.concatenate([
            rng.integers(0, 4_000, 1_940), np.full(60, 9_999)]))
        recs = pair.call(900, keys)
        assert all(len(r["shard_walk_s"]) == 2 for r in recs)
        assert all(sum(r["shard_n"]) == r["n"] for r in recs)
    finally:
        pair.close()


def test_no_records_without_a_list(small_chunks):
    """``stream_stats`` is None by default; a stream on each loop then
    records nothing, and ``_stream_rec`` returns None."""
    rng = np.random.default_rng(45)
    st = GpuBatchedStorage(num_slots=1024, clock_ms=lambda: T0,
                           device="cpu", host_parallel=0)
    try:
        lid = st.register_limiter("tb", RateLimitConfig(**CFG["tb"]))
        assert st.stream_stats is None
        keys = _zipf(rng, 2_000, 300)
        st.acquire_stream_ids("tb", lid, keys)
        st.acquire_stream_ids("tb", lid, keys, 1 + keys % 45)
        st.acquire_stream_ids("tb", lid, keys, 1 + keys % 400,
                              batch=256, subbatches=4)
        assert st.last_stream_chunks
        assert st.stream_stats is None
        assert st._stream_rec("relay", n=1) is None
    finally:
        st.close()
