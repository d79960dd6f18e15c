"""The port's weighted relay and its stream routing against the JAX
package's, on the CPU.

- The weighted steps (``*_relay_weighted``: rank-major scan;
  ``*_relay_weighted_counts``: coalesced) on layouts built by
  ``native_index.weighted_layout``: decision bits or counts and the whole
  packed state equal the reference's after every step.
- The two weighted bindings give what the reference's give.
- ``GpuBatchedStorage(device="cpu").acquire_stream_ids`` decides like
  ``TpuBatchedStorage.acquire_stream_ids`` and like ``semantics/oracle.py``
  on a clock that holds still within a call, through every route and mode
  (each chunk's ``mode`` is asserted): the weighted relay's three modes,
  the flat step (a lid array under eviction churn, a limit past the relay
  word's count clamp, oversize permits) and the K-step scan; and the two
  inputs that once took the flat step in the interim, now in the relay's
  resident digest and words mode.

Every quantity is an integer, so every comparison is exact.
"""

import numpy as np
import pytest
import torch

from ratelimiter_tpu.core.config import RateLimitConfig as RefConfig
from ratelimiter_tpu.engine import native_index as ref_native
from ratelimiter_tpu.engine.engine import DeviceEngine as RefEngine
from ratelimiter_tpu.engine.state import LimiterTable as RefTable
from ratelimiter_tpu.storage import tpu as ref_storage_mod
from ratelimiter_tpu.storage.tpu import TpuBatchedStorage
from ratelimiter_tpu_torch import RateLimitConfig
from ratelimiter_tpu_torch.engine import native_index
from ratelimiter_tpu_torch.engine.engine import DeviceEngine
from ratelimiter_tpu_torch.engine.state import (
    LimiterTable,
    load_reference_state,
)
from ratelimiter_tpu_torch.semantics import (
    SlidingWindowOracle,
    TokenBucketOracle,
)
from ratelimiter_tpu_torch.storage import gpu as gpu_mod
from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage
from torch_reference_native import (  # noqa: F401 (autouse fixture)
    idle_reference_flushers,
    require_reference_native,
)

torch.set_num_threads(1)

NUM_SLOTS = 512
CFG = {"tb": dict(max_permits=30, window_ms=2_000, refill_rate=10.0),
       "sw": dict(max_permits=40, window_ms=2_000,
                  enable_local_cache=False)}


# -- the weighted steps against the JAX package -------------------------------
def _engines(algo):
    require_reference_native()
    ref_table = RefTable()
    lid = ref_table.register(RefConfig(**CFG[algo]))
    ref = RefEngine(NUM_SLOTS, ref_table)
    port = DeviceEngine(NUM_SLOTS, LimiterTable(device="cpu"), device="cpu")
    load_reference_state(
        port, np.asarray(ref.sw_packed), np.asarray(ref.tb_packed),
        [ref_table.host_policy(l) for l in range(len(ref_table))])
    return ref, port, lid


def _assert_state_equal(ref, port, algo, msg):
    want = np.asarray(ref.sw_packed if algo == "sw" else ref.tb_packed)
    got = (port.sw_packed if algo == "sw" else port.tb_packed).numpy()
    np.testing.assert_array_equal(got, want, err_msg=msg)


def _layout(uwords, uidx, rank, permits, rank_bits, n):
    """The storage's rank-major layout, through the port's binding, held
    equal to the reference binding's."""
    u = len(uwords)
    r_b = 2
    while r_b < int(rank.max()) + 1:
        r_b *= 2
    u_b = gpu_mod._bucket_fine(u)
    outs = []
    for layout in (native_index.weighted_layout, ref_native.weighted_layout):
        uw_sorted = np.full(u_b, 0xFFFFFFFF, dtype=np.uint32)
        spos = np.empty(u, dtype=np.int32)
        roff = np.empty(r_b, dtype=np.int64)
        perms_rank = np.zeros(gpu_mod._bucket_fine(n) + u_b, dtype=np.uint8)
        ok = layout(uwords, rank_bits, uidx, rank, permits, r_b, uw_sorted,
                    spos, roff, perms_rank)
        assert ok is not False, f"{layout.__module__}.weighted_layout failed"
        outs.append((uw_sorted, spos, roff, perms_rank))
    for got, want in zip(*outs):
        np.testing.assert_array_equal(got, want)
    return outs[0], r_b


@pytest.mark.parametrize("algo", ["tb", "sw"])
def test_weighted_steps_match_reference(algo):
    """Rank-major steps over chunks with keys repeated up to ~10 times and
    permits in [1, 45] (some above max_permits), the clock rolling windows
    and stepping back; then coalesced steps with one weight per key.
    Bits and counts, each request's decision and the whole state agree."""
    rng = np.random.default_rng(5 if algo == "tb" else 6)
    ref, port, lid = _engines(algo)
    index = native_index.NativeSlotIndex(NUM_SLOTS)
    rb = port.rank_bits
    for step, now in enumerate((11_000, 11_900, 11_400, 13_500, 20_000)):
        n = 900
        keys = rng.integers(0, 300, n)
        uwords, uidx, rank, _ = index.assign_batch_ints_uniques(keys, lid, rb)
        permits = rng.integers(1, 46, n).astype(np.int64)
        (uw_sorted, spos, roff, perms_rank), r_b = _layout(
            uwords, uidx, rank, permits, rb, n)
        want = np.asarray(getattr(ref, f"{algo}_weighted_dispatch")(
            uw_sorted, perms_rank, roff, lid, now, r_b))
        got = getattr(port, f"{algo}_weighted_dispatch")(
            uw_sorted, perms_rank, roff, lid, now, r_b).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"step {step}")
        _assert_state_equal(ref, port, algo, f"step {step}")
        decided = native_index.weighted_decide(got, roff, spos, uidx, rank)
        np.testing.assert_array_equal(
            decided, ref_native.weighted_decide(want, roff, spos, uidx, rank))
        np.testing.assert_array_equal(
            decided, np.unpackbits(got)[roff[rank] + spos[uidx]])
        assert 0 < decided.sum() < n

        # Coalesced: every repeat of a key carries the key's weight.
        keys = rng.integers(0, 300, n)
        uwords, uidx, rank, _ = index.assign_batch_ints_uniques(keys, lid, rb)
        wlane = np.zeros(len(uwords), dtype=np.uint8)
        wlane[uidx] = 1 + keys % 37
        want = np.asarray(getattr(ref, f"{algo}_weighted_counts_dispatch")(
            uwords, wlane, lid, now + 50, np.uint8))
        got = getattr(port, f"{algo}_weighted_counts_dispatch")(
            uwords, wlane, lid, now + 50, np.uint8).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"step {step}")
        _assert_state_equal(ref, port, algo, f"coalesced step {step}")


def test_weighted_layout_refuses_counts_past_r_b():
    index = native_index.NativeSlotIndex(64)
    uwords, uidx, rank, _ = index.assign_batch_ints_uniques(
        np.zeros(5, dtype=np.int64), 1, 20)
    with pytest.raises(ValueError, match="r_b"):
        native_index.weighted_layout(
            uwords, 20, uidx, rank, np.ones(5, dtype=np.int64), 4,
            np.empty(1, np.uint32), np.empty(1, np.int32),
            np.empty(4, np.int64), np.zeros(8, np.uint8))


# -- the storage's routes against the reference and the oracle ----------------
class Pair:
    """A reference and a port storage on one clock, with the same
    limiters and the same host index (``host_parallel`` partitions, 0 for
    one index), and an oracle per limiter."""

    def __init__(self, algo, cfgs, num_slots=4096, host_parallel=0):
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
        self.lids, self.oracles = [], {}
        for cfg in cfgs:
            lid = self.ref.register_limiter(algo, RefConfig(**cfg))
            assert self.port.register_limiter(
                algo, RateLimitConfig(**cfg)) == lid
            self.lids.append(lid)
            self.oracles[lid] = (TokenBucketOracle if algo == "tb"
                                 else SlidingWindowOracle)(
                RateLimitConfig(**cfg))

    def call(self, dt, lid, keys, permits=None, oracle=True, **kw):
        """One stream call on both storages after the clock moves ``dt``:
        the port's decisions equal the reference's and (with ``oracle``)
        the oracle's in arrival order; returns the port's chunk modes."""
        self.clock["t"] += dt
        want = self.ref.acquire_stream_ids(self.algo, lid, keys, permits,
                                           **kw)
        got = self.port.acquire_stream_ids(self.algo, lid, keys, permits,
                                           **kw)
        np.testing.assert_array_equal(got, want)
        if oracle:
            now = self.clock["t"]
            lids = np.broadcast_to(lid, len(keys))
            ps = (np.ones(len(keys), dtype=np.int64) if permits is None
                  else permits)
            truth = [self.oracles[int(l)].try_acquire(int(k), int(p),
                                                      now).allowed
                     for l, k, p in zip(lids, keys, ps)]
            np.testing.assert_array_equal(got, truth)
        assert 0 < got.sum() < len(keys)
        return [c["mode"] for c in self.port.last_stream_chunks]

    def close(self):
        self.ref.close()
        self.port.close()


# The differential tests below run on one host index and on four
# partitions of it; the one-index cases keep their plain ids.
ON_HOST_INDEXES = pytest.mark.parametrize(
    "algo,host_parallel", [("tb", 0), ("sw", 0), ("tb", 4), ("sw", 4)],
    ids=["tb", "sw", "tb-hp4", "sw-hp4"])


def _zipf(rng, n, n_keys):
    return ((rng.zipf(1.1, n) - 1) % n_keys).astype(np.int64)


@pytest.fixture
def small_flat(monkeypatch):
    """Flat steps of at most 512 lanes in both storages."""
    for mod in (ref_storage_mod, gpu_mod):
        monkeypatch.setattr(mod, "_FLAT_MAX_LANES", 512)


@ON_HOST_INDEXES
def test_weighted_stream_modes(algo, host_parallel, small_flat):
    """One limiter, permits in [1, 45]: rank-major chunks (keys repeat a
    few times), coalesced chunks (one weight per key), flat fallback chunks
    (a hot key past 64 repeats; 3000 requests in flat steps of 512), in
    turns, on one state, the clock rolling windows between calls."""
    rng = np.random.default_rng(31 if algo == "tb" else 32)
    pair = Pair(algo, [CFG[algo]], host_parallel=host_parallel)
    lid = pair.lids[0]
    try:
        for rnd in range(2):
            keys = rng.integers(0, 3_000, 2_000)
            assert pair.call(700, lid, keys,
                             rng.integers(1, 46, 2_000)) == ["weighted"]
            keys = _zipf(rng, 3_000, 300)
            assert pair.call(900, lid, keys,
                             1 + keys % 45) == ["weighted_coal"]
            keys = _zipf(rng, 3_000, 300)
            assert pair.call(1_300, lid, keys,
                             rng.integers(1, 46, 3_000)) == ["flat_fb"]
    finally:
        pair.close()


@pytest.mark.parametrize("algo", ["tb", "sw"])
def test_weighted_stream_chunks_grow(algo, monkeypatch):
    """Chunks of 256 requests growing to 1024 at most: every chunk of a
    call decides at the call's time, whatever mode it takes."""
    for mod in (ref_storage_mod, gpu_mod):
        monkeypatch.setattr(mod, "_RELAY_CHUNK", 256)
        monkeypatch.setattr(mod, "_RELAY_CHUNK_MAX", 1024)
    rng = np.random.default_rng(41)
    pair = Pair(algo, [CFG[algo]])
    try:
        keys = _zipf(rng, 3_000, 2_000)
        modes = pair.call(500, pair.lids[0], keys,
                          rng.integers(1, 46, 3_000))
        assert len(modes) > 3 and modes[0] == "weighted"
        assert set(modes) <= {"weighted", "flat_fb"}
        assert sum(c["requests"] for c in pair.port.last_stream_chunks) \
            == 3_000
    finally:
        pair.close()


def test_weighted_coalescing_past_count_clamp_follows_oracle():
    """A key repeated past the relay word's count clamp (1023 at 2^20
    slots) with one weight, under a limit above the clamp: the clamped
    count would cut the key's allowed prefix short, so the port takes the
    flat fallback and decides like the oracle.  The reference coalesces
    and denies the requests past the clamp (ROADMAP.md C3)."""
    for algo in ("tb", "sw"):
        cfg = dict(max_permits=5_000, window_ms=60_000)
        if algo == "tb":
            cfg["refill_rate"] = 5.0
        else:
            cfg["enable_local_cache"] = False
        pair = Pair(algo, [cfg], num_slots=1 << 20)
        try:
            lid = pair.lids[0]
            assert pair.port.engine.rank_bits == 10
            assert not pair.port.engine.relay_usable()
            keys = np.r_[np.full(2_000, 7), np.arange(100, 600)]
            permits = np.ones(len(keys), dtype=np.int64)
            pair.clock["t"] += 100
            ref = pair.ref.acquire_stream_ids(algo, lid, keys, permits)
            got = pair.port.acquire_stream_ids(algo, lid, keys, permits)
            now = pair.clock["t"]
            truth = [pair.oracles[lid].try_acquire(int(k), 1, now).allowed
                     for k in keys]
            np.testing.assert_array_equal(got, truth)
            assert [c["mode"] for c in pair.port.last_stream_chunks] == [
                "flat_fb"]
            assert (ref != got).sum() == 2_000 - 1_023
        finally:
            pair.close()


@ON_HOST_INDEXES
def test_flat_lid_array_under_eviction_churn(algo, host_parallel):
    """Per-request limiter ids with a permits lane (0, above max_permits,
    past 255) on a 128-slot table over ~1800 (lid, key) pairs: each call's
    evictions are cleared before its step, as the reference clears them."""
    rng = np.random.default_rng(51 if algo == "tb" else 52)
    cfgs = [CFG[algo], dict(CFG[algo], max_permits=7)]
    pair = Pair(algo, cfgs, num_slots=128, host_parallel=host_parallel)
    try:
        for call in range(5):
            n = 100
            lids = rng.choice(pair.lids, n)
            keys = rng.integers(0, 900, n)
            permits = rng.integers(0, 300, n)
            assert pair.call(400, lids, keys, permits, oracle=False,
                             batch=32, subbatches=2) == ["flat"] * 2
    finally:
        pair.close()


@ON_HOST_INDEXES
def test_flat_routes_match_oracle(algo, host_parallel):
    """The inputs the flat step serves, with room for every key: a lid
    array with a permits lane, permits past the weighted cap, oversize
    permits (denied, state untouched), and a limit past the relay word's
    count clamp with unit permits."""
    rng = np.random.default_rng(61 if algo == "tb" else 62)
    wide = dict(CFG[algo], max_permits=40_000)
    pair = Pair(algo, [CFG[algo], dict(CFG[algo], max_permits=7), wide],
                num_slots=(1 << 16) - 64, host_parallel=host_parallel)
    try:
        eng = pair.port.engine
        assert not eng.relay_usable() and eng.counts_dtype() is np.uint16
        narrow = pair.lids[:2]
        for call in range(3):
            n = 1_500
            keys = _zipf(rng, n, 400)
            lids = rng.choice(narrow, n)
            assert pair.call(600, lids, keys, rng.integers(1, 50, n),
                             batch=256, subbatches=2) == ["flat"] * 3
            permits = rng.integers(1, 400, n)
            permits[rng.random(n) < 0.05] = np.iinfo(np.int64).max
            assert pair.call(900, narrow[0], keys, permits,
                             batch=1_024, subbatches=2) == ["flat"]
            hot = np.r_[np.full(41_000, 3), keys[:1_000]]
            assert pair.call(700, pair.lids[2],
                             rng.permutation(hot)) == ["flat"]
    finally:
        pair.close()


@pytest.mark.parametrize("algo", ["tb", "sw"])
def test_interim_flat_routes_match_reference_relay(algo):
    """The two inputs that took the flat step until the relay's other
    modes were ported now take them, as the reference does, and decide
    alike: a lid array with unit permits takes the resident digest, and
    limits past uint16 counts take words mode."""
    rng = np.random.default_rng(71 if algo == "tb" else 72)
    cfgs = [CFG[algo], dict(CFG[algo], max_permits=9)]
    pair = Pair(algo, cfgs)
    try:
        for call in range(3):
            keys = _zipf(rng, 2_000, 200)
            lids = np.asarray(pair.lids)[keys % 2]
            assert pair.call(800, lids, keys) == ["resident"]
    finally:
        pair.close()
    huge = dict(CFG[algo], max_permits=70_000)
    if algo == "tb":
        huge["refill_rate"] = 20_000.0
    pair = Pair(algo, [huge])
    try:
        assert pair.port.engine.counts_dtype() is None
        for call in range(3):
            keys = rng.permutation(np.r_[np.full(72_000, 1),
                                         _zipf(rng, 1_000, 50)])
            assert pair.call(2_100, pair.lids[0], keys, batch=1 << 14,
                             subbatches=8) == ["words"]
    finally:
        pair.close()


@ON_HOST_INDEXES
def test_scan_route_matches_oracle(algo, host_parallel, small_flat):
    """Super-batches past the flat lane cap run as K-step scans, the tail
    super-batch with fewer steps; one limiter with a permits lane, and a
    lid array with a permits lane of ones (unit permits without a lane
    take the relay)."""
    rng = np.random.default_rng(81 if algo == "tb" else 82)
    pair = Pair(algo, [CFG[algo], dict(CFG[algo], max_permits=9)],
                host_parallel=host_parallel)
    try:
        for call in range(2):
            keys = _zipf(rng, 3_000, 500)
            assert pair.call(1_100, pair.lids[0], keys,
                             rng.integers(1, 300, 3_000), batch=256,
                             subbatches=8) == ["scan", "scan"]
            lids = np.asarray(pair.lids)[keys % 2]
            ones = np.ones(len(keys), dtype=np.int64)
            assert pair.call(500, lids, keys, ones, batch=512,
                             subbatches=1) == ["flat"] * 6
            assert pair.call(500, lids, keys, ones, batch=2_048,
                             subbatches=1) == ["scan", "scan"]
        chunks = pair.port.last_stream_chunks
        assert [c["requests"] for c in chunks] == [2_048, 952]
    finally:
        pair.close()


def test_stream_argument_errors():
    """The reference's two ValueErrors: limiter ids outside the table, and
    permits below int32."""
    pair = Pair("tb", [CFG["tb"]])
    try:
        keys = np.arange(4)
        for storage in (pair.ref, pair.port):
            with pytest.raises(ValueError, match="limiter ids out of range"):
                storage.acquire_stream_ids("tb", np.array([1, 1, 5, 1]),
                                           keys)
            with pytest.raises(ValueError, match="limiter ids out of range"):
                storage.acquire_stream_ids("tb", np.array([1, -1, 1, 1]),
                                           keys)
            with pytest.raises(ValueError, match="below int32"):
                storage.acquire_stream_ids(
                    "tb", 1, keys, np.array([1, 1, -(1 << 31) - 1, 1]))
    finally:
        pair.close()
