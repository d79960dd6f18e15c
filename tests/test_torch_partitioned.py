"""The port's partitioned host slot index and its election against the
JAX package's.

- The routing copies (``engine/routing.py``) and the C routing passes
  equal the reference's ``shard_of_int_keys`` / ``shard_of_key`` /
  ``fnv_fingerprint_h1`` on seeded int64 keys (negatives and extremes) and
  on ``(lid, str)`` keys.
- ``engine/partitioned.py:PartitionedSlotIndex`` equals the reference's
  ``ratelimiter_tpu/engine/partitioned.py`` op for op under eviction churn
  and pins: slots, clears, and unique words (``uwords``, ``uidx``,
  ``rank``) for int, multi-lid int and string keys.
- The storages elect the same partition count
  (``storage/gpu.py:elect_host_parallel`` against
  ``TpuBatchedStorage._auto_host_parallel``), and with partitions in place
  a port storage evicts the keys the reference evicts, where one index
  over the same slots keeps them.

At most 4 partitions; every storage is closed in a ``finally``.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ratelimiter_tpu.core.config import RateLimitConfig as RefConfig
from ratelimiter_tpu.engine import native_index as ref_native
from ratelimiter_tpu.engine.partitioned import (
    PartitionedSlotIndex as RefPartitioned,
)
from ratelimiter_tpu.parallel import sharded as ref_sharded
from ratelimiter_tpu.storage.tpu import TpuBatchedStorage
from ratelimiter_tpu_torch import RateLimitConfig
from ratelimiter_tpu_torch.engine import native_index, routing
from ratelimiter_tpu_torch.engine.partitioned import PartitionedSlotIndex
from ratelimiter_tpu_torch.storage.gpu import (
    GpuBatchedStorage,
    elect_host_parallel,
)
from test_torch_slice import _Side, _keys
from torch_reference_native import (  # noqa: F401 (autouse fixture)
    idle_reference_flushers,
    require_reference_native,
)

torch.set_num_threads(1)

I64 = np.iinfo(np.int64)


def _same(got, want, what=""):
    """Equal outputs: tuples element by element, arrays and lists as
    arrays (values and length), scalars and None as they are."""
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{what}[{i}]")
    elif isinstance(want, (np.ndarray, list)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=what)
    else:
        assert got == want, what


# -- (a) routing ---------------------------------------------------------------
def test_routing_matches_reference():
    require_reference_native()
    rng = np.random.default_rng(101)
    ints = np.r_[rng.integers(I64.min, I64.max, 4_000, dtype=np.int64),
                 rng.integers(-50, 50, 100),
                 [0, 1, -1, I64.min, I64.max, I64.min + 1, I64.max - 1]]
    strs = ([f"k{i}" for i in rng.integers(0, 10**9, 2_000)]
            + ["", "é", "中文", "a" * 300, "tab\tkey"])
    for n in (1, 2, 3, 4, 7, 8):
        np.testing.assert_array_equal(
            routing.shard_of_int_keys(ints, n),
            ref_sharded.shard_of_int_keys(ints, n))
        _same(native_index.shard_route(ints, n), ref_native.shard_route(
            ints, n), f"shard_route n={n}")
        for lid in (0, 1, 7, 1 << 40):
            h1, h2 = native_index.hash_str_keys(strs, lid)
            want = ref_native.hash_str_keys(strs, lid)
            np.testing.assert_array_equal(h1, want[0])
            np.testing.assert_array_equal(h2, want[1])
            _same(native_index.route_hashes(h1, n),
                  ref_native.route_hashes(want[0].copy(), n),
                  f"route_hashes n={n} lid={lid}")
            for s in strs[:50] + strs[-5:]:
                assert (routing.shard_of_key((lid, s), n)
                        == ref_sharded.shard_of_key((lid, s), n)
                        == int(h1[strs.index(s)] % np.uint64(n)))
                assert (routing.fnv_fingerprint_h1(s.encode(), lid)
                        == ref_native.fnv_fingerprint_h1(s.encode(), lid))
        for key in [(3, int(k)) for k in ints[:20]] + [
                int(ints[0]), "bare", b"raw", (2, b"raw"), 1.5, ("x", "y"),
                (1, 2, 3)]:
            assert (routing.shard_of_key(key, n)
                    == ref_sharded.shard_of_key(key, n)), key


# -- (b) the index against the reference's ------------------------------------
class _Both:
    """The reference's and the port's partitioned index, driven alike."""

    def __init__(self, num_slots, n_parts):
        self.ref = RefPartitioned(num_slots, n_parts)
        self.port = PartitionedSlotIndex(num_slots, n_parts)
        self.evictions = 0

    def call(self, name, *args, **kw):
        want = getattr(self.ref, name)(*args, **kw)
        got = getattr(self.port, name)(*args, **kw)
        _same(got, want, name)
        if isinstance(got, tuple) and len(got) in (2, 4) and not isinstance(
                got[-1], (int, type(None))):
            self.evictions += len(got[-1])
        return got

    def close(self):
        self.ref.close()
        self.port.close()


@pytest.mark.parametrize("num_slots", [256, 4096])
@pytest.mark.parametrize("n_parts", [2, 4])
def test_partitioned_index_matches_reference(num_slots, n_parts):
    """Rounds of every batched assign (pinned sets, held pins released
    after, string windows), explicit pins across a batch, and the scalar
    contract, over three times more keys than slots."""
    require_reference_native()
    rng = np.random.default_rng(num_slots + n_parts)
    both = _Both(num_slots, n_parts)
    universe = 3 * num_slots
    batch = num_slots // 4
    rb = 31 - num_slots.bit_length()
    try:
        held = np.zeros(0, dtype=np.int32)
        for rnd in range(6):
            hold = rnd % 2 == 0
            pinned = set(int(s) for s in rng.choice(held, 4)) if len(
                held) else None
            keys = rng.integers(-universe // 2, universe // 2, batch)
            lids = rng.integers(1, 4, batch)
            strs = [f"user{k}" for k in rng.integers(0, universe, batch)]
            start = int(rng.integers(0, batch // 4))
            count = batch - start - int(rng.integers(0, batch // 4))
            for name, args, kw in (
                    ("assign_batch_ints", (keys, 3), {}),
                    ("assign_batch_ints_multi", (keys, lids), {}),
                    ("assign_batch_ints_uniques", (keys, 5, rb), {}),
                    ("assign_batch_ints_multi_uniques", (keys, lids, rb),
                     {}),
                    ("assign_batch_strs", (strs, 5),
                     dict(start=start, count=count)),
                    ("assign_batch_strs_uniques", (strs, 6, rb),
                     dict(start=start, count=count))):
                got = both.call(name, *args, pinned=pinned, hold_pins=hold,
                                **kw)
                slots = (got[0] if len(got) == 2
                         else (got[0] >> np.uint32(rb + 1)).astype(np.int32))
                if hold:
                    both.ref.unpin_batch(slots)
                    both.port.unpin_batch(slots)
                held = slots
            # Explicit pins hold a few slots across a batch.
            pins = rng.choice(held, 8)
            both.ref.pin_batch(pins)
            both.port.pin_batch(pins)
            both.call("assign_batch_ints",
                      rng.integers(0, universe, batch), 9)
            both.ref.unpin_batch(pins)
            both.port.unpin_batch(pins)
            for k in rng.integers(0, universe, 12).tolist():
                key = (int(rng.integers(1, 4)), k if k % 2 else f"user{k}")
                slot, _ = both.call("assign", key, pinned=pinned,
                                    hold_pin=True)
                both.ref.unpin_batch([slot])
                both.port.unpin_batch([slot])
                both.call("get", key)
                if k % 3 == 0:
                    both.call("remove", key)
            assert len(both.port) == len(both.ref)
        assert both.evictions > 0
    finally:
        both.close()


# -- (c) the fault: partitions evict what one index keeps ---------------------
def test_partition_eviction_matches_reference():
    """16_484 keys that route to partition 0 of 4 fill its 16384 slots of
    a 2^16-slot table and evict the first 100: re-requested, they find
    fresh state on the reference and on the port with the same
    partitions (allowed), and their spent state on one index over the
    same slots (denied; the port's index before partitions were ported).
    The port's close shuts the partitions' thread pools."""
    require_reference_native()
    clock = {"t": 1_700_000_000_000}
    cfg = dict(max_permits=1, window_ms=60_000, refill_rate=0.001)
    ref = TpuBatchedStorage(num_slots=1 << 16,
                            clock_ms=lambda: clock["t"],
                            observability=False, host_parallel=4)
    port = GpuBatchedStorage(num_slots=1 << 16, clock_ms=lambda: clock["t"],
                             device="cpu", host_parallel=4)
    single = GpuBatchedStorage(num_slots=1 << 16,
                               clock_ms=lambda: clock["t"], device="cpu",
                               host_parallel=0)
    try:
        lid = ref.register_limiter("tb", RefConfig(**cfg))
        for st in (port, single):
            assert st.register_limiter("tb", RateLimitConfig(**cfg)) == lid
        cand = np.arange(80_000, dtype=np.int64)
        keys = cand[ref_sharded.shard_of_int_keys(cand, 4) == 0][:16_484]
        assert len(keys) == 16_484
        for i in range(0, len(keys), 4_096):
            clock["t"] += 1
            chunk = keys[i:i + 4_096]
            want = ref.acquire_stream_ids("tb", lid, chunk)
            assert want.all()
            np.testing.assert_array_equal(
                port.acquire_stream_ids("tb", lid, chunk), want)
            np.testing.assert_array_equal(
                single.acquire_stream_ids("tb", lid, chunk), want)
        clock["t"] += 1
        want = ref.acquire_stream_ids("tb", lid, keys[:100])
        got = port.acquire_stream_ids("tb", lid, keys[:100])
        np.testing.assert_array_equal(got, want)
        assert want.all()
        assert [c["host_parallel"] for c in port.last_stream_chunks] == [4]
        assert not single.acquire_stream_ids("tb", lid, keys[:100]).any()
    finally:
        ref.close()
        port.close()
        single.close()
    assert all(ix._pool._shutdown for ix in port._index.values())


# -- (d) the election ----------------------------------------------------------
@pytest.mark.parametrize("cores", [1, 2, 3, 6, 8, 16])
def test_election_matches_reference(cores, monkeypatch):
    """The partition count each storage elects, as a function of the
    table size and the host's cores, with the reference's native library
    reported present."""
    monkeypatch.setattr(os, "sched_getaffinity",
                        lambda pid: set(range(cores)))
    monkeypatch.setattr(ref_native, "native_available", lambda: True)
    for num_slots in ((1 << 16) - 64, 1 << 16, 3 << 16, 2_000_128,
                      12_500_224):
        stub = SimpleNamespace(engine=SimpleNamespace(num_slots=num_slots))
        want = TpuBatchedStorage._auto_host_parallel(stub, False)
        assert elect_host_parallel(num_slots) == want, num_slots
    if cores == 3:
        assert elect_host_parallel(2_000_128) == 2  # 3 does not divide it
        assert elect_host_parallel(3 << 16) == 3


def test_storage_builds_the_elected_or_explicit_index(monkeypatch):
    """``host_parallel=None`` builds the elected index, an explicit count
    wins (0 and 1 mean one index), and a count that does not divide the
    table raises on both storages."""
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: {0, 1, 2, 3})
    made = []
    try:
        for kw, want in ((dict(num_slots=1 << 16), 4),
                         (dict(num_slots=(1 << 16) - 64), 0),
                         (dict(num_slots=1 << 16, host_parallel=0), 0),
                         (dict(num_slots=1 << 16, host_parallel=1), 0),
                         (dict(num_slots=4096, host_parallel=2), 2)):
            st = GpuBatchedStorage(device="cpu", **kw)
            made.append(st)
            assert st._host_parallel == want, kw
            for index in st._index.values():
                assert (isinstance(index, PartitionedSlotIndex)
                        and index.n_parts == want) if want else (
                    isinstance(index, native_index.NativeSlotIndex))
    finally:
        for st in made:
            st.close()
    require_reference_native()
    for storage, kw in ((TpuBatchedStorage, dict(observability=False)),
                        (GpuBatchedStorage, dict(device="cpu"))):
        with pytest.raises(ValueError, match="divide evenly"):
            storage(num_slots=4096, host_parallel=3, **kw)


# -- the micro route on partitions ---------------------------------------------
def test_micro_route_on_partitions_matches_reference():
    """Singles, bursts (one limiter: the batched string assign), a
    mixed-limiter batch (the scalar assign), available permits and admin
    resets, through both storages on 4 partitions of 64 slots each over
    400 keys: decisions, availability and each key's packed row agree."""
    require_reference_native()
    clock = {"t": 1_700_000_000_000}
    ref = _Side(True, lambda: clock["t"], 256, host_parallel=4)
    port = _Side(False, lambda: clock["t"], 256, host_parallel=4)
    rng = np.random.default_rng(7)
    try:
        for rnd in range(5):
            clock["t"] += int(rng.integers(0, 9_000))
            for i, key in enumerate(_keys(rng, 40, 400)):
                name = ("api", "auth", "burst")[i % 3]
                p = int(rng.integers(1, 4))
                assert (port.limiters[name].try_acquire(key, p)
                        == ref.limiters[name].try_acquire(key, p))
            for name in ("auth", "burst"):
                keys = _keys(rng, 60, 400)
                permits = rng.integers(1, 4, 60)
                np.testing.assert_array_equal(
                    port.limiters[name].try_acquire_many(keys, permits),
                    ref.limiters[name].try_acquire_many(keys, permits))
            lids = [ref.limiters[("api", "auth")[j % 2]]._lid
                    for j in range(30)]
            keys = _keys(rng, 30, 400)
            perms = [1] * 30
            want = ref.storage.acquire_many("sw", lids, keys, perms)
            got = port.storage.acquire_many("sw", lids, keys, perms)
            np.testing.assert_array_equal(got["allowed"], want["allowed"])
            probe = _keys(rng, 8, 400)
            for name in ("auth", "burst"):
                np.testing.assert_array_equal(
                    port.limiters[name].available_permits_many(probe),
                    ref.limiters[name].available_permits_many(probe))
                port.limiters[name].reset(probe[0])
                ref.limiters[name].reset(probe[0])
        for name in ("auth", "burst"):
            for key in _keys(rng, 50, 400):
                r, p = ref.row(name, key), port.row(name, key)
                assert (r is None) == (p is None)
                if r is not None:
                    np.testing.assert_array_equal(p, r)
    finally:
        ref.storage.close()
        port.storage.close()


def test_partitioned_index_under_concurrent_callers():
    """Four threads assign, look up and remove keys of one partitioned
    index at once (batched and scalar, the interpreter switching threads
    every microsecond): afterwards every held key maps to its own slot in
    its own partition, and the index holds as many keys as are held."""
    import sys
    import threading

    index = PartitionedSlotIndex(256, 4)
    errors = []

    def worker(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(40):
                index.assign_batch_ints(rng.integers(0, 600, 24), 1)
                index.assign_batch_strs(
                    [f"s{k}" for k in rng.integers(0, 600, 24)], 2)
                key = (1, int(rng.integers(0, 600)))
                slot, _ = index.assign(key, hold_pin=True)
                index.unpin_batch([slot])
                if rng.random() < 0.3:
                    index.remove(key)
        except Exception as exc:  # noqa: BLE001 — asserted below
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(s,))
                   for s in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        index.close()
    assert not errors, errors
    held = {}
    for key in [(1, k) for k in range(600)] + [(2, f"s{k}")
                                               for k in range(600)]:
        slot = index.get(key)
        if slot is not None:
            assert slot // index.slots_per_part == routing.shard_of_key(
                key, 4)
            held[key] = slot
    assert len(set(held.values())) == len(held) == len(index)


def test_string_packers_match_reference():
    """Batches the one-join packer takes (a list and a tuple of str, one
    key, none) and batches it leaves to the per-key packer (a key holding
    a NUL, bytes keys) pack to the reference's bytes and offsets by
    either packer, and hash to the reference's fingerprints."""
    require_reference_native()
    batches = [[f"k{i}" for i in range(50)] + ["", "é", "中文"],
               tuple(f"t{i}" for i in range(7)), ["one"], [],
               ["a", "b\x00c", "", "d"], [b"raw", b"", b"x\x00y"]]
    for keys in batches:
        want = ref_native._pack_str_keys(keys)
        for got in (native_index._pack_str_keys(keys),
                    native_index._pack_keys_each(keys)):
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
        for got, ref in zip(native_index.hash_str_keys(keys, 3),
                            ref_native.hash_str_keys(keys, 3)):
            np.testing.assert_array_equal(got, ref)


def test_string_hashing_refuses_bad_windows():
    """A window past the key list or fingerprint lanes of two lengths
    raise before any pointer reaches the C passes, on one index and on
    partitions."""
    keys = ["a", "b", "c"]
    assert len(native_index.hash_str_keys(keys, 1, 1, 2)[0]) == 2
    for start, count in ((2, 2), (-1, 1), (0, -1)):
        with pytest.raises(ValueError, match="window"):
            native_index.hash_str_keys(keys, 1, start, count)
    h1, h2 = native_index.hash_str_keys(keys, 1)
    parts = PartitionedSlotIndex(16, 2)
    try:
        for index in (native_index.NativeSlotIndex(16), parts):
            for name, args in (("assign_batch_fps", (h1, h2[:2])),
                               ("assign_batch_fps_uniques",
                                (h1, h2[:2], 20))):
                with pytest.raises(ValueError, match="fingerprints"):
                    getattr(index, name)(*args)
    finally:
        parts.close()
