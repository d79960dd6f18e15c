"""The port's sharded engine (``ratelimiter_tpu_torch/parallel/``) against
the JAX package's.

The reference's ``ShardedDeviceEngine`` runs on ``make_mesh(n_devices=2 or
4)`` of the forced host devices (``tests/conftest.py``); the port's runs
its shards as CPU tensors (``devices=["cpu"] * n``).  Both get the same
configs, keys, permits and clock:

- routing: the splitmix64 pass on tensors, the engine's
  ``route_on_device``, the C routers ``rl_shard_route2`` /
  ``rl_route_hashes2`` and the reference's on-mesh ``build_route_count``
  agree on every key's shard, order and counts (keys of 2^63 and above
  as uint64, negative keys, 0);
- the micro step, the peek, the clears, the flat and scan dispatches:
  outputs equal, each shard's packed rows byte-equal, equal
  ``last_step_totals``;
- the sharded storages' streams (the relay digest and words mode per
  shard, tenant lid arrays, permit lanes and oversize permits on the flat
  step, string keys, several chunks) under eviction churn, window
  rollover and the clock stepping back; and the micro route, peeks and
  resets through the batcher; decisions and states equal, and equal to a
  flat port storage's where no key is evicted;
- leases, journals (the reference's ``mark_matrix`` /
  ``mark_words_matrix``, and marks that follow the step), scoped fences,
  checkpoints either package restores, and ``build_storage``'s choice.

Slots stay at most 2^10 a shard; every storage is closed in a
``finally``.
"""

import numpy as np
import pytest
import torch

from ratelimiter_tpu.core.config import RateLimitConfig as RefConfig
from ratelimiter_tpu.engine import native_index as ref_native
from ratelimiter_tpu.engine import state as ref_state
from ratelimiter_tpu.engine.state import LimiterTable as RefTable
from ratelimiter_tpu.parallel import ShardedDeviceEngine as RefEngine
from ratelimiter_tpu.parallel import make_mesh
from ratelimiter_tpu.parallel import sharded as ref_sharded
from ratelimiter_tpu.storage import tpu as ref_tpu
from ratelimiter_tpu.storage.errors import FencedError as RefFencedError
from ratelimiter_tpu.storage.tpu import TpuBatchedStorage
from ratelimiter_tpu_torch import RateLimitConfig
from ratelimiter_tpu_torch.engine import native_index, routing
from ratelimiter_tpu_torch.engine import state as port_state
from ratelimiter_tpu_torch.engine.state import LimiterTable
from ratelimiter_tpu_torch.parallel import (
    ShardedDeviceEngine,
    ShardedSlotIndex,
    make_devices,
)
from ratelimiter_tpu_torch.service import wiring
from ratelimiter_tpu_torch.service.props import AppProperties
from ratelimiter_tpu_torch.storage import gpu as port_gpu
from ratelimiter_tpu_torch.storage.errors import FencedError
from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage
from torch_reference_native import (  # noqa: F401 (autouse fixture)
    idle_reference_flushers,
    require_reference_native,
)

torch.set_num_threads(1)

T0 = 1_700_000_000_000
I64 = np.iinfo(np.int64)
SPS = 512  # slots a shard in the storage tests: keys outnumber them
TB = dict(max_permits=20, window_ms=1000, refill_rate=5.0)
SW = dict(max_permits=15, window_ms=1000)
TIGHT = dict(max_permits=1, window_ms=1000, refill_rate=1.0)


def _engines(n: int, sps: int):
    """The reference's and the port's sharded engine over ``n`` shards,
    the same limiters registered in both (lids 1-3)."""
    ref_t, port_t = RefTable(), LimiterTable(device="cpu")
    for cfg in (TB, SW, TIGHT):
        assert ref_t.register(RefConfig(**cfg)) == port_t.register(
            RateLimitConfig(**cfg))
    ref = RefEngine(sps, ref_t, mesh=make_mesh(n_devices=n))
    port = ShardedDeviceEngine(sps, port_t, devices=["cpu"] * n)
    return ref, port


def _same_state(ref, port) -> None:
    """Every shard's packed rows byte-equal, both algorithms."""
    for algo in ("sw", "tb"):
        want = np.asarray(getattr(ref, f"{algo}_packed"))
        np.testing.assert_array_equal(
            port.packed_host(algo), want.reshape(-1, want.shape[-1]),
            err_msg=algo)


# The tests' engines, one pair per (shards, copy), kept for the module:
# the reference compiles its jitted shard_map steps per engine, so each
# test takes the pair with its state zeroed instead of new ones.  Lids
# 1-3 are TB, SW and TIGHT; each storage pair registers its own after.
_ENGINES: dict = {}


def _zeroed_engines(n: int, copy: int):
    key = (n, copy)
    if key not in _ENGINES:
        _ENGINES[key] = _engines(n, SPS)
    ref, port = _ENGINES[key]
    for algo in ("sw", "tb"):
        state = getattr(ref, f"{algo}_state")
        setattr(ref, f"{algo}_state", type(state)(*(
            np.zeros(np.shape(f), dtype=np.int64) for f in state)))
        state = getattr(port, f"{algo}_state")
        setattr(port, f"{algo}_state", type(state)(*(
            torch.zeros_like(f) for f in state)))
    return ref, port


class _Pair:
    """A reference and a port storage over sharded engines of ``n``
    shards (``SPS`` slots a shard, zeroed; ``copy`` tells two pairs of one
    test apart), on one clock, with the limiters of :data:`TB`, :data:`SW`
    and :data:`TIGHT` registered in both."""

    def __init__(self, n: int, copy: int = 0):
        self.t = T0
        ref_e, port_e = _zeroed_engines(n, copy)
        self.ref = TpuBatchedStorage(engine=ref_e, clock_ms=self.now,
                                     observability=False)
        self.port = GpuBatchedStorage(engine=port_e, clock_ms=self.now)
        self.lids = {}
        for name, algo, cfg in (("tb", "tb", TB), ("sw", "sw", SW),
                                ("tight", "tb", TIGHT)):
            a = self.ref.register_limiter(algo, RefConfig(**cfg))
            b = self.port.register_limiter(algo, RateLimitConfig(**cfg))
            assert a == b
            self.lids[name] = a

    def now(self) -> int:
        return self.t

    def both(self, name, *args, **kw):
        want = getattr(self.ref, name)(*args, **kw)
        got = getattr(self.port, name)(*args, **kw)
        return want, got

    def same(self, name, *args, **kw):
        want, got = self.both(name, *args, **kw)
        np.testing.assert_array_equal(got, want, err_msg=name)
        return got

    def same_state(self):
        self.ref.flush()
        self.port.flush()
        _same_state(self.ref.engine, self.port.engine)

    def close(self):
        self.ref.close()
        self.port.close()


@pytest.fixture(params=[2, 4])
def pair(request):
    require_reference_native()
    p = _Pair(request.param)
    try:
        yield p
    finally:
        p.close()


# -- routing ---------------------------------------------------------------------
def _route_keys(rng):
    big = rng.integers(0, I64.max, 3000, dtype=np.int64).astype(
        np.uint64) + np.uint64(1 << 63)  # keys of 2^63 and above
    return np.r_[big.view(np.int64),
                 rng.integers(I64.min, 0, 2000, dtype=np.int64),
                 rng.integers(0, 100, 500),
                 [0, 1, -1, I64.min, I64.max]].astype(np.int64)


@pytest.mark.parametrize("n", [2, 4])
def test_routing_matches_reference(n):
    require_reference_native()
    rng = np.random.default_rng(7)
    keys = _route_keys(rng)
    want_shard = ref_sharded.shard_of_int_keys(keys, n)
    want_order = np.argsort(want_shard, kind="stable")
    want_counts = np.bincount(want_shard, minlength=n)
    ref_eng, port_eng = _engines(n, 64)
    h1, h2 = native_index.hash_str_keys([f"k{i}" for i in range(3000)], 5)
    for got in (routing.route_count(torch.from_numpy(keys), n, True),
                port_eng.route_on_device(key_ids=keys),
                ref_eng.route_on_device(key_ids=keys),
                native_index.shard_route_gather(keys, n),
                ref_native.shard_route_gather(keys, n)):
        shard, order, counts = (np.asarray(x) for x in got[:3])
        np.testing.assert_array_equal(shard, want_shard)
        np.testing.assert_array_equal(order, want_order)
        np.testing.assert_array_equal(counts, want_counts)
    np.testing.assert_array_equal(
        native_index.shard_route_gather(keys, n)[3], keys[want_order])
    # String keys route by their fingerprint's h1.
    hs = (h1 % np.uint64(n)).astype(np.int64)
    ho = np.argsort(hs, kind="stable")
    want = ref_native.route_hashes_gather(h1, h2, n)
    got = native_index.route_hashes_gather(h1, h2, n)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], hs)
    np.testing.assert_array_equal(got[3], h1[ho])
    for got in (port_eng.route_on_device(hashes=h1),
                ref_eng.route_on_device(hashes=h1)):
        np.testing.assert_array_equal(got[0], hs)
        np.testing.assert_array_equal(got[1], ho)


def test_splitmix_on_tensors_matches_numpy():
    rng = np.random.default_rng(8)
    keys = _route_keys(rng)
    for n in (1, 3, 7, 8, 13, (1 << 31) - 1):
        np.testing.assert_array_equal(
            routing.mod_u64(routing.splitmix64(torch.from_numpy(keys)), n)
            .numpy(), routing.shard_of_int_keys(keys, n))


def test_make_devices():
    assert make_devices(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    assert make_devices(["cpu"] * 4, n_devices=2) == [torch.device("cpu")] * 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_devices()
    with pytest.raises(ValueError):
        make_devices([])


def test_slot_index_routes_and_pins():
    require_reference_native()
    ref = ref_sharded.ShardedSlotIndex(32, 4)
    port = ShardedSlotIndex(32, 4)
    for i in range(300):  # past capacity: evictions within each shard
        key = (1, f"user{i % 150}")
        want = ref.assign(key, pinned={1, 40, 70})
        got = port.assign(key, pinned={1, 40, 70})
        assert got == want
        assert got[0] // 32 == routing.shard_of_key(key, 4)
    assert len(port) == len(ref)
    for i in range(150):
        assert port.get((1, f"user{i}")) == ref.get((1, f"user{i}"))
    assert port.remove((1, "user149")) == ref.remove((1, "user149"))


# -- the engine ------------------------------------------------------------------
def _micro_batch(rng, num_slots, n):
    slots = rng.integers(0, num_slots, n)
    slots[rng.random(n) < 0.3] = slots[0]  # a hot slot
    slots[rng.random(n) < 0.05] = -1       # padding lanes
    lids = rng.integers(1, 4, n)
    permits = rng.integers(1, 23, n)       # past max_permits too
    return slots, lids, permits


@pytest.mark.parametrize("n", [2, 4])
def test_micro_step_matches_reference(n):
    require_reference_native()
    rng = np.random.default_rng(10 + n)
    ref, port = _zeroed_engines(n, 0)
    now = T0
    for step in range(6):
        now += int(rng.integers(-300, 700))  # rollover, and back
        slots, lids, permits = _micro_batch(rng, ref.num_slots, 200)
        for algo in ("sw", "tb"):
            want = getattr(ref, f"{algo}_acquire")(slots, lids, permits, now)
            got = getattr(port, f"{algo}_acquire")(slots, lids, permits, now)
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                              err_msg=f"{algo} {k}")
            assert port.last_step_totals == tuple(
                int(x) for x in ref.last_step_totals)
        peek = slots[slots >= 0][:50]
        for algo in ("sw", "tb"):
            np.testing.assert_array_equal(
                getattr(port, f"{algo}_available")(peek, lids[:len(peek)],
                                                   now),
                getattr(ref, f"{algo}_available")(peek, lids[:len(peek)],
                                                  now))
        if step % 3 == 2:
            hot = [int(slots[0]), int(rng.integers(0, ref.num_slots))]
            ref.sw_clear(hot)
            port.sw_clear(hot)
            ref.tb_clear(hot)
            port.tb_clear(hot)
        _same_state(ref, port)
    rows = port.read_rows("tb", [0, ref.num_slots - 1, 5])
    np.testing.assert_array_equal(rows, ref.read_rows("tb", [0, ref.num_slots - 1, 5]))


@pytest.mark.parametrize("n", [2, 4])
def test_flat_and_scan_dispatch_match_reference(n):
    require_reference_native()
    rng = np.random.default_rng(20 + n)
    ref, port = _zeroed_engines(n, 0)
    b = 256
    for algo in ("tb", "sw"):
        for call in range(3):
            now = T0 + 400 * call
            slots = rng.integers(-1, 40, (n, b)).astype(np.int32)
            lids = rng.integers(1, 4, (n, b)).astype(np.int32)
            perms = rng.integers(1, 6, (n, b)).astype(np.int32)
            flat = f"{algo}_flat_sharded_dispatch"
            want = np.asarray(getattr(ref, flat)(slots, lids, perms, now))
            got = port.fetch_matrix(
                getattr(port, flat)(slots, lids, perms, now), b // 8,
                np.uint8)
            np.testing.assert_array_equal(got, want)
        k = 2
        slots = rng.integers(-1, 40, (n, k, b)).astype(np.int32)
        perms = rng.integers(1, 6, (n, k, b)).astype(np.int32)
        now_k = np.array([T0 + 1500, T0 + 1900], dtype=np.int64)
        scan = f"{algo}_scan_dispatch"
        want = np.asarray(getattr(ref, scan)(slots, np.int32(1), perms,
                                             now_k))
        handle = getattr(port, scan)(slots, 1, perms, now_k)
        for q in range(n):
            np.testing.assert_array_equal(port.fetch(q, handle[q]), want[q])
    _same_state(ref, port)


@pytest.mark.parametrize("n", [2, 4])
def test_relay_shard_dispatch_and_clear_match_reference(n):
    require_reference_native()
    rng = np.random.default_rng(30 + n)
    ref, port = _zeroed_engines(n, 0)
    rb = port.rank_bits
    assert rb == ref.rank_bits
    for call in range(4):
        now = T0 + 500 * call
        for q in range(n):
            slots = rng.choice(128, 40, replace=False).astype(np.uint32)
            counts = rng.integers(1, 30, 40).astype(np.uint32)
            words = np.full(64, 0xFFFFFFFF, dtype=np.uint32)
            words[:40] = (slots << np.uint32(rb + 1)) | (counts << 1)
            for algo in ("tb", "sw"):
                want = np.asarray(ref.relay_shard_dispatch(
                    algo, q, "counts", words, 1 if algo == "tb" else 2,
                    now, np.uint8))
                got = port.fetch(q, port.relay_shard_dispatch(
                    algo, q, "counts", words, 1 if algo == "tb" else 2,
                    now, np.uint8))
                np.testing.assert_array_equal(got, want)
                lane = rng.integers(1, 4, 64).astype(np.int32)
                want = np.asarray(ref.relay_shard_dispatch(
                    algo, q, "counts", words, lane, now, np.uint8))
                got = port.fetch(q, port.relay_shard_dispatch(
                    algo, q, "counts", words, lane, now, np.uint8))
                np.testing.assert_array_equal(got, want)
            # words mode: one word a request, the last of a slot flagged
            w = np.full(64, 0xFFFFFFFF, dtype=np.uint32)
            s = rng.integers(0, 128, 48).astype(np.uint32)
            s.sort()
            rank = np.zeros(48, dtype=np.uint32)
            for i in range(1, 48):
                rank[i] = rank[i - 1] + 1 if s[i] == s[i - 1] else 0
            last = np.r_[s[1:] != s[:-1], True].astype(np.uint32)
            w[:48] = (s << np.uint32(rb + 1)) | (rank << 1) | last
            want = np.asarray(ref.relay_shard_dispatch("tb", q, "bits", w,
                                                       np.int32(1), now))
            got = port.fetch(q, port.relay_shard_dispatch("tb", q, "bits", w,
                                                          1, now))
            np.testing.assert_array_equal(got, want)
            ref.clear_shard("tb", q, [1, 2, 127])
            port.clear_shard("tb", q, [1, 2, 127])
        _same_state(ref, port)


# -- the storages' routes ------------------------------------------------------------
def _zipf(rng, n, keys):
    return ((rng.zipf(1.1, n) - 1) % keys).astype(np.int64)


def test_unit_streams_match_reference(pair):
    """The relay per shard: digest (Zipf), words mode (uniform keys),
    tenant lid arrays and string keys, under eviction churn (fresh
    uniform keys every call on ``SPS`` slots a shard), window rollover
    and the clock stepping back."""
    rng = np.random.default_rng(40)
    n_sh = pair.port.engine.n_shards
    modes = set()
    for step in (0, 900, -400, 1200):
        pair.t += step
        zipf = _zipf(rng, 3000, 800)
        uniform = rng.integers(0, 1 << 40, 600)
        for name in ("tb", "sw", "tight"):
            algo = "sw" if name == "sw" else "tb"
            for keys in (zipf, uniform):
                pair.same("acquire_stream_ids", algo, pair.lids[name], keys)
                modes.update(m for m in pair.port.last_stream_chunks[0]
                             ["modes"] if m)
        lid_arr = rng.choice([pair.lids["tb"], pair.lids["tight"]], 1500)
        pair.same("acquire_stream_ids", "tb", lid_arr, zipf[:1500])
        pair.same("acquire_stream_ids", "tb", lid_arr[:600], uniform)
        strs = [f"u{k}" for k in zipf[:1500]]
        pair.same("acquire_stream_strs", "tb", pair.lids["tb"], strs)
        pair.same("acquire_stream_strs", "sw", pair.lids["sw"], strs)
        pair.same_state()
    assert modes == {"digest", "words"}, modes
    assert len(pair.port.last_stream_chunks[0]["shard_n"]) == n_sh


def test_permit_streams_match_reference(pair):
    """The flat step on every shard: permit lanes (max_permits edges),
    tenant lid arrays with permits, and oversize permits (denied, state
    untouched), in several super-batches."""
    rng = np.random.default_rng(41)
    for step in (0, -200, 1500):
        pair.t += step
        keys = _zipf(rng, 2000, 2000)
        permits = rng.integers(1, 22, 2000)
        for name in ("tb", "sw"):
            algo = "sw" if name == "sw" else "tb"
            pair.same("acquire_stream_ids", algo, pair.lids[name], keys,
                      permits, batch=512, subbatches=2)
        lid_arr = rng.choice([pair.lids["tb"], pair.lids["tight"]], 2000)
        pair.same("acquire_stream_ids", "tb", lid_arr, keys, permits,
                  batch=512, subbatches=2)
        over = permits.copy()
        over[::7] = 1 << 33
        pair.same("acquire_stream_ids", "tb", pair.lids["tb"], keys, over,
                  batch=512, subbatches=2)
        pair.same("acquire_stream_strs", "sw", pair.lids["sw"],
                  [f"s{k}" for k in keys[:300]], permits[:300])
        pair.same_state()
    assert pair.port.last_stream_chunks  # the flat route's records
    assert {r["mode"] for r in pair.port.last_stream_chunks} == {"flat"}


def test_multi_chunk_relay_matches_reference(pair, monkeypatch):
    for mod in (ref_tpu, port_gpu):
        monkeypatch.setattr(mod, "_RELAY_CHUNK", 1 << 10)
        monkeypatch.setattr(mod, "_RELAY_CHUNK_MAX", 1 << 10)
    rng = np.random.default_rng(42)
    for step in (0, 900):
        pair.t += step
        keys = _zipf(rng, 5000, 2500)
        pair.same("acquire_stream_ids", "tb", pair.lids["tb"], keys)
        assert len(pair.port.last_stream_chunks) == 5
        lid_arr = rng.choice([pair.lids["tb"], pair.lids["tight"]], 5000)
        pair.same("acquire_stream_ids", "tb", lid_arr, keys)
        pair.same("acquire_stream_strs", "sw", pair.lids["sw"],
                  [f"c{k}" for k in keys])
        pair.same_state()


def test_micro_route_matches_reference(pair):
    rng = np.random.default_rng(43)
    lids = pair.lids
    for step in range(5):
        pair.t += int(rng.integers(-200, 600))
        keys = [f"user{k}" for k in _zipf(rng, 60, 600)]
        for key in keys[:8]:
            for name in ("tb", "sw"):
                want, got = pair.both("acquire", name, lids[name], key,
                                      int(rng.integers(1, 4)))
                assert got["allowed"] == want["allowed"]
        permits = rng.integers(1, 22, len(keys)).tolist()
        for name in ("tb", "sw", "tight"):
            algo = "sw" if name == "sw" else "tb"
            want, got = pair.both("acquire_many", algo,
                                  [lids[name]] * len(keys), keys, permits)
            np.testing.assert_array_equal(got["allowed"], want["allowed"])
        ids = _zipf(rng, 200, 3000)
        want, got = pair.both("acquire_many_ids", "tb", lids["tb"], ids,
                              np.ones(200, dtype=np.int64))
        np.testing.assert_array_equal(got["allowed"], want["allowed"])
        pair.same("available_many", "tb", lids["tb"], keys[:30])
        pair.same("available_many", "sw", lids["sw"], keys[:30])
        if step % 3 == 1:
            for name in ("tb", "sw"):
                pair.both("reset_key", name, lids[name], keys[0])
        pair.same_state()


def test_sharded_decisions_equal_a_flat_storage():
    """The reference docstring's claim: a sharded stream decides as the
    flat single-device stream on the same per-key order (no key evicted
    on either side)."""
    require_reference_native()
    t = [T0]
    sharded = GpuBatchedStorage(
        engine=ShardedDeviceEngine(1 << 10, LimiterTable(device="cpu"),
                                   devices=["cpu"] * 4),
        clock_ms=lambda: t[0])
    flat = GpuBatchedStorage(num_slots=1 << 12, clock_ms=lambda: t[0],
                             device="cpu", host_parallel=0)
    try:
        lid = [st.register_limiter("tb", RateLimitConfig(**TB))
               for st in (sharded, flat)][0]
        sw = [st.register_limiter("sw", RateLimitConfig(**SW))
              for st in (sharded, flat)][0]
        rng = np.random.default_rng(44)
        for step in (0, 300, 800):
            t[0] += step
            keys = _zipf(rng, 4000, 1500)
            permits = rng.integers(1, 9, 4000)
            for args in (("tb", lid, keys), ("sw", sw, keys),
                         ("tb", lid, keys, permits)):
                np.testing.assert_array_equal(
                    sharded.acquire_stream_ids(*args),
                    flat.acquire_stream_ids(*args))
            strs = [f"k{k}" for k in keys[:1000]]
            np.testing.assert_array_equal(
                sharded.acquire_stream_strs("sw", sw, strs),
                flat.acquire_stream_strs("sw", sw, strs))
    finally:
        sharded.close()
        flat.close()


def test_leases_match_reference(pair):
    rng = np.random.default_rng(45)
    for step in range(3):
        pair.t += int(rng.integers(0, 700))
        for key in [f"lease{k}" for k in rng.integers(0, 40, 8)]:
            for name in ("tb", "sw"):
                want, got = pair.both("lease_reserve", name,
                                      pair.lids[name], key,
                                      int(rng.integers(0, 25)))
                assert got == want
                want, got = pair.both("lease_credit", name,
                                      pair.lids[name], key,
                                      int(rng.integers(-1, 6)), got["ws"])
                assert got == want
        pair.same_state()


def test_scoped_fences_match_reference(pair):
    n_sh = pair.port.engine.n_shards
    lid = pair.lids["tb"]
    keys = [f"f{i}" for i in range(64)]
    shard = {k: routing.shard_of_key((lid, k), n_sh) for k in keys}
    assert shard == {k: ref_sharded.shard_of_key((lid, k), n_sh)
                     for k in keys}
    for st in (pair.ref, pair.port):
        st.fence(3, shards=[0])
    fenced = [k for k in keys if shard[k] == 0]
    served = [k for k in keys if shard[k] != 0]
    for key in fenced[:3]:
        with pytest.raises(RefFencedError):
            pair.ref.acquire("tb", lid, key, 1)
        with pytest.raises(FencedError):
            pair.port.acquire("tb", lid, key, 1)
    for key in served[:5]:
        want, got = pair.both("acquire", "tb", lid, key, 1)
        assert got["allowed"] == want["allowed"]
    ints = np.arange(400, dtype=np.int64)
    ok = ints[routing.shard_of_int_keys(ints, n_sh) != 0]
    pair.same("acquire_stream_ids", "tb", lid, ok)
    with pytest.raises(FencedError):
        pair.port.acquire_stream_ids("tb", lid, ints)
    with pytest.raises(RefFencedError):
        pair.ref.acquire_stream_ids("tb", lid, ints)
    for key in keys[:16]:
        assert (pair.port.lease_scope_epoch(lid, key)
                == pair.ref.lease_scope_epoch(lid, key)
                == (3 if shard[key] == 0 else 0))
    assert pair.port.fence_info()["shards"] == pair.ref.fence_info()[
        "shards"] == [0]
    for st in (pair.ref, pair.port):
        st.lift_fence(3, shards=[0])
    want, got = pair.both("acquire", "tb", lid, fenced[0], 1)
    assert got["allowed"] == want["allowed"]


@pytest.mark.parametrize("n", [2, 4])
def test_checkpoints_restore_across_packages(n, tmp_path):
    require_reference_native()
    rng = np.random.default_rng(46 + n)
    a, b = _Pair(n), _Pair(n, copy=1)
    try:
        keys = _zipf(rng, 3000, 1000)
        a.same("acquire_stream_ids", "tb", a.lids["tb"], keys)
        a.same("acquire_stream_strs", "sw", a.lids["sw"],
               [f"c{k}" for k in keys[:800]])
        a.port.save_checkpoint(str(tmp_path / "port"))
        a.ref.save_checkpoint(str(tmp_path / "ref"))
        b.ref.restore_checkpoint(str(tmp_path / "port"))
        b.port.restore_checkpoint(str(tmp_path / "ref"))
        b.same_state()
        _same_state(a.ref.engine, b.port.engine)
        for pr in (a, b):
            pr.t += 450
        more = _zipf(rng, 3000, 1000) + 500
        for pr in (a, b):
            pr.same("acquire_stream_ids", "tb", pr.lids["tb"], more)
        np.testing.assert_array_equal(
            b.port.acquire_stream_ids("sw", b.lids["sw"], more),
            a.port.acquire_stream_ids("sw", a.lids["sw"], more))
        np.testing.assert_array_equal(
            b.ref.acquire_stream_ids("sw", b.lids["sw"], more),
            a.ref.acquire_stream_ids("sw", a.lids["sw"], more))
        b.same_state()
    finally:
        a.close()
        b.close()


# -- journals ----------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["host", "device"])
def test_journal_matrices_match_reference(kind):
    rng = np.random.default_rng(47)
    sps, n = 64, 4
    make = {"host": (ref_state.SlotJournal, port_state.SlotJournal),
            "device": (ref_state.DeviceSlotJournal,
                       lambda s: port_state.DeviceSlotJournal(s, "cpu"))}
    ref_cls, port_cls = make[kind]
    ref, port = ref_cls(sps * n), port_cls(sps * n)
    rb = 31 - sps.bit_length()
    for _ in range(3):
        mat = rng.integers(-1, sps, (n, 40)).astype(np.int32)
        ref.mark_matrix("tb", mat, sps)
        port.mark_matrix("tb", mat, sps)
        loc = rng.integers(0, sps, (n, 3, 16)).astype(np.uint32)
        words = (loc << np.uint32(rb + 1)) | np.uint32(3)
        words[:, :, -2:] = 0xFFFFFFFF
        ref.mark_words_matrix("sw", words, rb, sps)
        port.mark_words_matrix("sw", words, rb, sps)
        port.mark_words_matrix("sw", torch.from_numpy(words.view(np.int32)),
                               rb, sps)
        want, got = ref.drain()[0], port.drain()[0]
        assert set(got) == set(want)
        for algo in want:
            np.testing.assert_array_equal(got[algo], want[algo])


class _PeekJournal(port_state.SlotJournal):
    """A host journal that reads the engine's rows of every slot it is
    told to mark, at the moment of the mark."""

    def __init__(self, engine):
        super().__init__(engine.num_slots)
        self.engine = engine
        self.seen = []

    def mark(self, algo, slots):
        a = np.asarray(slots, dtype=np.int64).reshape(-1)
        a = a[(a >= 0) & (a < self.num_slots)]
        if len(a):
            self.seen.append(self.engine.read_rows(algo, a))
        super().mark(algo, slots)


def test_marks_follow_the_step():
    """Every dispatch path marks its slots once its step is enqueued: a
    mark already sees the row the step wrote (the reference marks before
    its step, ROADMAP C10)."""
    _, eng = _engines(2, 64)
    j = eng.journal = _PeekJournal(eng)
    slots = np.array([3, 70, 100, 5])
    eng.tb_acquire(slots, [1] * 4, [1] * 4, T0)
    eng.sw_acquire(slots, [2] * 4, [1] * 4, T0)
    eng.tb_flat_sharded_dispatch(
        np.array([[9, -1], [10, -1]], dtype=np.int32), 1, None, T0)
    words = np.array([(11 << (eng.rank_bits + 1)) | 2, 0xFFFFFFFF],
                     dtype=np.uint32)
    eng.relay_shard_dispatch("tb", 1, "counts", words, 1, T0, np.uint8)
    eng.write_rows("tb", [20], np.array([[7, 0, 1, 0]], dtype=np.int32))
    assert len(j.seen) == 5
    for rows in j.seen:
        assert (rows != 0).any(axis=1).all(), rows
    dirty = j.drain()[0]
    np.testing.assert_array_equal(dirty["tb"],
                                  [3, 5, 9, 20, 70, 74, 75, 100])
    np.testing.assert_array_equal(dirty["sw"], [3, 5, 70, 100])


# -- wiring ------------------------------------------------------------------------
def test_build_storage_shards_over_several_devices():
    props = AppProperties({"storage.num_slots": "4096"})
    cpu = torch.device("cpu")
    assert wiring.sharded_engine(props, [cpu]) is None
    eng = wiring.sharded_engine(props, [cpu, cpu, cpu])
    assert isinstance(eng, ShardedDeviceEngine)
    assert (eng.n_shards, eng.slots_per_shard) == (3, 4096 // 3)
    for value in ("auto", "true", "on"):
        props = AppProperties({"storage.num_slots": "4096",
                               "parallel.shard": value})
        assert wiring.sharded_engine(props, [cpu, cpu]).n_shards == 2
    off = AppProperties({"storage.num_slots": "4096",
                         "parallel.shard": "off"})
    assert wiring.sharded_engine(off, [cpu, cpu]) is None
    st = GpuBatchedStorage(engine=eng, clock_ms=lambda: T0)
    try:
        assert st._host_parallel == 0
        assert isinstance(st._index["tb"], ShardedSlotIndex)
        lid = st.register_limiter("tb", RateLimitConfig(**TB))
        assert st.acquire("tb", lid, "alice", 1)["allowed"]
    finally:
        st.close()
    flat = wiring.build_storage(AppProperties({"storage.num_slots": "4096"}),
                                device="cpu")
    try:
        assert not hasattr(flat.engine, "n_shards")
    finally:
        flat.close()
    with pytest.raises(ValueError):
        GpuBatchedStorage(engine=ShardedDeviceEngine(
            1024, LimiterTable(device="cpu"), devices=["cpu"] * 2),
            host_parallel=4)
    assert port_gpu.elect_host_parallel(1 << 20, sharded=True) == 0
