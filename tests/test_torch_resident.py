"""The relay's words mode and resident digest against the JAX package's,
on the CPU.

- ``*_relay_bits`` (words mode) with one limiter id and with a lid lane,
  over chunks whose keys repeat past the rank clamp, with padding lanes
  and a clock that steps back: the allow bits and the whole packed state
  equal the reference's composed step after every step.
- ``*_relay_counts_resident`` with fresh (slot, lid) pairs, padded pairs
  and a step that uploads none: counts, the whole state and the lid map
  equal the reference engine's.
- The two bindings words mode and the tenant relay need
  (``rebuild_words_into``, ``assign_batch_ints_multi_uniques``) give what
  the reference's give, and what the reference's numpy
  ``rebuild_words`` gives.
- ``GpuBatchedStorage(device="cpu").acquire_stream_ids`` with unit
  permits decides like ``TpuBatchedStorage.acquire_stream_ids`` and like
  ``semantics/oracle.py``, and each chunk takes the mode the reference's
  chunk took: tenant streams under eviction churn (a slot reassigned to
  another limiter gets its lid uploaded again) with admin resets between
  calls, and one-limiter streams over uniform and Zipf keys.

Every quantity is an integer, so every comparison is exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ratelimiter_tpu.core.config import RateLimitConfig as RefConfig
from ratelimiter_tpu.engine import native_index as ref_native
from ratelimiter_tpu.engine.engine import DeviceEngine as RefEngine
from ratelimiter_tpu.engine.state import LimiterTable as RefTable
from ratelimiter_tpu.ops import relay as ref_relay
from ratelimiter_tpu.ops.sliding_window import make_sw_packed as ref_sw_state
from ratelimiter_tpu.ops.token_bucket import make_tb_packed as ref_tb_state
from ratelimiter_tpu.storage import tpu as ref_storage_mod
from ratelimiter_tpu.storage.tpu import TpuBatchedStorage
from ratelimiter_tpu_torch import RateLimitConfig
from ratelimiter_tpu_torch.engine import native_index
from ratelimiter_tpu_torch.engine.engine import DeviceEngine
from ratelimiter_tpu_torch.engine.state import (
    LimiterTable,
    load_reference_state,
)
from ratelimiter_tpu_torch.ops import relay
from ratelimiter_tpu_torch.ops.sliding_window import make_sw_packed
from ratelimiter_tpu_torch.ops.token_bucket import make_tb_packed
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

CFG = {"tb": [dict(max_permits=9, window_ms=900, refill_rate=4.0),
              dict(max_permits=5, window_ms=2_000, refill_rate=1.5)],
       "sw": [dict(max_permits=9, window_ms=900, enable_local_cache=False),
              dict(max_permits=5, window_ms=2_000,
                   enable_local_cache=False)]}


def _tables(algo):
    ref, port = RefTable(), LimiterTable(device="cpu")
    lids = []
    for cfg in CFG[algo]:
        lid = ref.register(RefConfig(**cfg))
        assert port.register(RateLimitConfig(**cfg)) == lid
        lids.append(lid)
    return ref, port, lids


# -- words mode against the reference's composed step -------------------------
@pytest.mark.parametrize("algo", ["tb", "sw"])
@pytest.mark.parametrize("lane", [False, True], ids=["one-lid", "lid-lane"])
def test_relay_bits_match_reference(algo, lane):
    """Words from the C index at rank_bits 4 (the count clamp at 15), so
    hot keys repeat past the clamp; a power-of-two padding tail; one
    limiter id, or a lane of the two limiters' ids with a few ids past the
    table (clipped to its last row, as the reference clips them); the
    clock rolling windows and stepping back once."""
    require_reference_native()
    rng = np.random.default_rng(3 if algo == "tb" else 4)
    s_rows, rb = 512, 4
    ref_tab, port_tab, lids = _tables(algo)
    index = native_index.NativeSlotIndex(s_rows)
    ref_state = (ref_tb_state if algo == "tb" else ref_sw_state)(s_rows)
    port_state = (make_tb_packed if algo == "tb" else make_sw_packed)(
        s_rows, "cpu")
    ref_step = jax.jit(functools.partial(
        ref_relay.tb_relay_bits if algo == "tb" else ref_relay.sw_relay_bits,
        rank_bits=rb))
    port_step = relay.tb_relay_bits if algo == "tb" else relay.sw_relay_bits
    now = 1_000
    clamped = 0
    for step in range(6):
        now += -700 if step == 3 else int(rng.integers(100, 1_500))
        n = int(rng.integers(200, 400))
        keys = np.r_[np.full(20, step), rng.integers(10, 300, n - 20)]
        keys = rng.permutation(keys)
        uwords, uidx, rank, _ = index.assign_batch_ints_uniques(
            keys, lids[0], rb)
        clamped += int((rank >= (1 << rb) - 1).sum())
        words = np.full(512, 0xFFFFFFFF, dtype=np.uint32)
        native_index.rebuild_words_into(uwords, uidx, rank, rb, words[:n])
        if lane:
            lid_lane = np.zeros(512, dtype=np.int32)
            lid_lane[:n] = np.asarray(lids)[keys % 2]
            lid_lane[:n][rng.random(n) < 0.05] = 1_000
            ref_lids, port_lids = (jnp.asarray(lid_lane),
                                   torch.from_numpy(lid_lane))
        else:
            ref_lids = jnp.int32(lids[0])
            port_lids = torch.tensor(lids[0], dtype=torch.int64)
        ref_state, want = ref_step(ref_state, ref_tab.device_arrays,
                                   jnp.asarray(words), ref_lids,
                                   jnp.int64(now))
        got = port_step(port_state, port_tab.device_arrays,
                        torch.from_numpy(words.view(np.int32).copy()),
                        port_lids, now, rank_bits=rb)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"step {step}")
        np.testing.assert_array_equal(port_state.numpy(),
                                      np.asarray(ref_state),
                                      err_msg=f"step {step}")
        allowed = np.unpackbits(got.numpy())[:n]
        assert 0 < allowed.sum() < n
    assert clamped > 0


def test_rebuild_words_bindings_match_reference():
    """Per-request words through the port's C pass, the reference's C
    pass and the reference's numpy form, with segments past the count
    clamp; the C pass writes only its lanes of a padded buffer and
    refuses a buffer it cannot write."""
    require_reference_native()
    rng = np.random.default_rng(9)
    rb = 5
    index = native_index.NativeSlotIndex(2048)
    for step in range(4):
        keys = np.r_[np.full(70, 3), (rng.zipf(1.1, 500) - 1) % 900]
        uwords, uidx, rank, _ = index.assign_batch_ints_uniques(
            rng.permutation(keys), 2, rb)
        n = len(uidx)
        got = np.full(n + 37, 0xFFFFFFFF, dtype=np.uint32)
        native_index.rebuild_words_into(uwords, uidx, rank, rb, got[:n])
        want = np.empty(n, dtype=np.uint32)
        assert ref_native.rebuild_words_into(uwords, uidx, rank, rb, want)
        np.testing.assert_array_equal(got[:n], want)
        assert (got[n:] == 0xFFFFFFFF).all()
        np.testing.assert_array_equal(
            ref_relay.rebuild_words(uwords, uidx, rank, rb), want)
        assert int((want & 1).sum()) == len(uwords)
    with pytest.raises(ValueError, match="out"):
        native_index.rebuild_words_into(uwords, uidx, rank, rb,
                                        np.empty(2 * n, np.uint32)[::2])
    with pytest.raises(ValueError, match="out"):
        native_index.rebuild_words_into(uwords, uidx, rank, rb,
                                        np.empty(n - 1, np.uint32))


def test_multi_uniques_binding_matches_reference():
    """Tenant keys (the same key under two limiters is two uniques)
    through both bindings, with eviction churn and pinned slots: words,
    unique indices, ranks and evictions agree."""
    require_reference_native()
    rng = np.random.default_rng(13)
    s = 256
    rb = 31 - s.bit_length()
    ref, port = ref_native.NativeSlotIndex(s), native_index.NativeSlotIndex(s)
    evicted = 0
    for step in range(8):
        keys = (rng.zipf(1.1, 300) - 1) % 600
        lids = rng.integers(1, 4, 300)
        pinned = set(rng.choice(s, 5).tolist()) if step % 2 else None
        want = ref.assign_batch_ints_multi_uniques(keys, lids, rb,
                                                   pinned=pinned,
                                                   hold_pins=True)
        got = port.assign_batch_ints_multi_uniques(keys, lids, rb,
                                                   pinned=pinned,
                                                   hold_pins=True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        evicted += len(want[3])
        held = (want[0] >> np.uint32(rb + 1)).astype(np.int32)
        ref.unpin_batch(held)
        port.unpin_batch(held)
    assert evicted > 0
    with pytest.raises(ValueError, match="limiter ids"):
        port.assign_batch_ints_multi_uniques(np.arange(4), np.ones(3), rb)


# -- the resident digest against the reference engine -------------------------
@pytest.mark.parametrize("algo", ["tb", "sw"])
def test_relay_counts_resident_match_reference(algo):
    """Digest steps whose (slot, lid) pairs arrive fresh (first touches,
    then slots handed to the other limiter), padded to 8 or 16 lanes with
    slot -1, or not at all (every pair already resident); sorted and
    unsorted words with a padding tail.  Counts, the whole state and the
    lid map equal the reference engine's after every step."""
    require_reference_native()
    rng = np.random.default_rng(17 if algo == "tb" else 18)
    ref_table = RefTable()
    lids = [ref_table.register(RefConfig(**cfg)) for cfg in CFG[algo]]
    ref = RefEngine(512, ref_table)
    port = DeviceEngine(512, LimiterTable(device="cpu"), device="cpu")
    load_reference_state(
        port, np.asarray(ref.sw_packed), np.asarray(ref.tb_packed),
        [ref_table.host_policy(l) for l in range(len(ref_table))],
        sw_lid_map=np.asarray(ref.sw_lid_map),
        tb_lid_map=np.asarray(ref.tb_lid_map))
    rb = port.rank_bits
    lid_of = np.zeros(512, dtype=np.int32)
    now = 5_000
    for step in range(7):
        now += int(rng.integers(200, 1_200))
        u = int(rng.integers(40, 120))
        slots = rng.choice(512, u, replace=False)
        if step % 3 == 2:
            slots.sort()
        counts = rng.integers(1, 14, u)
        uwords = np.full(128, 0xFFFFFFFF, dtype=np.uint32)
        uwords[:u] = ((slots.astype(np.uint32) << np.uint32(rb + 1))
                      | (counts.astype(np.uint32) << np.uint32(1)))
        if step == 4:
            fresh = np.zeros(0, dtype=np.int64)   # every pair resident
        else:
            fresh = rng.choice(slots, int(rng.integers(1, 14)),
                               replace=False)
            lid_of[fresh] = rng.choice(lids, len(fresh))
        size = 8 if len(fresh) <= 8 else 16
        d_slots = np.full(size, -1, dtype=np.int32)
        d_slots[:len(fresh)] = fresh
        d_lids = np.zeros(size, dtype=np.int32)
        d_lids[:len(fresh)] = lid_of[fresh]
        dtype = np.uint8 if step % 2 else np.uint16
        want = np.asarray(getattr(ref, f"{algo}_relay_counts_resident_dispatch")(
            uwords, d_slots, d_lids, now, dtype))
        got = getattr(port, f"{algo}_relay_counts_resident_dispatch")(
            uwords, d_slots, d_lids, now, dtype).numpy()
        assert got.dtype == dtype
        np.testing.assert_array_equal(got, want, err_msg=f"step {step}")
        for name in (f"{algo}_packed", f"{algo}_lid_map"):
            np.testing.assert_array_equal(
                getattr(port, name).numpy(), np.asarray(getattr(ref, name)),
                err_msg=f"{name} step {step}")
        assert 0 < got[:u].sum() < counts.sum()


# -- the storage's relay modes against the reference and the oracle -----------
class Pair:
    """A reference and a port storage on one clock with the same
    limiters and the same host index (``host_parallel`` partitions, 0 for
    one index), an oracle per limiter, and the reference's chunk
    records."""

    def __init__(self, algo, cfgs, num_slots, host_parallel=0):
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
            self.oracles[lid] = (TokenBucketOracle if self.algo == "tb"
                                 else SlidingWindowOracle)(
                RateLimitConfig(**cfg))

    def call(self, dt, lid, keys, oracle=True):
        """One unit-permit stream call on both storages after the clock
        moves ``dt``: the port's decisions equal the reference's (and the
        oracle's, with ``oracle``), and each chunk's mode is the one the
        reference's chunk took.  Returns the port's chunk records."""
        self.clock["t"] += dt
        self.ref.stream_stats = []
        want = self.ref.acquire_stream_ids(self.algo, lid, keys)
        got = self.port.acquire_stream_ids(self.algo, lid, keys)
        np.testing.assert_array_equal(got, want)
        chunks = self.port.last_stream_chunks
        multi = np.ndim(lid) != 0
        ref_modes = [{"bits": "words",
                      "digest": "resident" if multi else "relay"}[r["mode"]]
                     for r in self.ref.stream_stats]
        self.ref.stream_stats = None
        assert [c["mode"] for c in chunks] == ref_modes
        assert sum(c["requests"] for c in chunks) == len(keys)
        if oracle:
            now = self.clock["t"]
            truth = [self.oracles[int(l)].try_acquire(int(k), 1, now).allowed
                     for l, k in zip(np.broadcast_to(lid, len(keys)), keys)]
            np.testing.assert_array_equal(got, truth)
        assert 0 < got.sum() < len(keys)
        return chunks

    def reset(self, lid, key):
        self.ref.reset_key(self.algo, lid, key)
        self.port.reset_key(self.algo, lid, key)
        self.oracles[lid].reset(key, self.clock["t"])

    def assert_lid_maps_equal(self):
        name = f"{self.algo}_lid_map"
        np.testing.assert_array_equal(
            getattr(self.port.engine, name).numpy(),
            np.asarray(getattr(self.ref.engine, name)))

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


@ON_HOST_INDEXES
def test_tenant_streams_under_eviction_churn(algo, host_parallel):
    """Two limiters, a lid per request, 900 (lid, key) pairs over 512
    slots: each call evicts, and a slot handed to a pair of the other
    limiter must have its lid uploaded again.  Uniform calls elect words
    mode, Zipf calls the resident digest; after every call the decisions,
    the modes, the lid maps and the whole state equal the reference's, and
    every slot the port's index holds maps to its pair's lid."""
    rng = np.random.default_rng(23 if algo == "tb" else 24)
    pair = Pair(algo, CFG[algo], num_slots=512, host_parallel=host_parallel)
    try:
        modes = []
        deltas = reassigned = 0
        owner = {}
        for call in range(8):
            if call % 3 == 0:
                # Distinct, mostly fresh pairs (a hot key for denials).
                keys = np.r_[rng.choice(450, 390, replace=False),
                             np.full(10, 460)]
            else:
                keys = _zipf(rng, 500, 450)
            lids = np.asarray(pair.lids)[(keys + call) % 2]
            chunks = pair.call(600, lids, keys, oracle=False)
            modes += [c["mode"] for c in chunks]
            deltas += sum(c["deltas"] for c in chunks)
            pair.assert_lid_maps_equal()
            name = f"{algo}_packed"
            np.testing.assert_array_equal(
                getattr(pair.port.engine, name).numpy(),
                np.asarray(getattr(pair.ref.engine, name)))
            # Every slot whose lid the port counts as uploaded maps to the
            # lid of the pair that holds it now.  A lookup refreshes the
            # key's recency, so both indexes take it, in the same order.
            known = pair.port._lid_known[algo]
            lid_map = getattr(pair.port.engine, f"{algo}_lid_map").numpy()
            for l, k in sorted(set(zip(lids.tolist(), keys.tolist()))):
                slot = pair.port._index[algo].get((l, k))
                assert slot == pair.ref._index[algo].get((l, k))
                if known[slot]:
                    assert lid_map[slot] == l, (l, k, slot)
                    reassigned += owner.get(slot, l) != l
                    owner[slot] = l
        assert {"words", "resident"} <= set(modes)
        assert deltas > 0 and reassigned > 0
    finally:
        pair.close()


@pytest.mark.parametrize("algo", ["tb", "sw"])
def test_tenant_streams_match_oracle(algo):
    """Room for every pair: tenant streams decide like the oracle, through
    admin resets between calls (a reset slot's lid is uploaded again at
    its next use) and window rollover; the second pass over the same
    pairs uploads no lid at all (the delta lanes at the floor of 8)."""
    rng = np.random.default_rng(27 if algo == "tb" else 28)
    pair = Pair(algo, CFG[algo], num_slots=4096)
    try:
        keys = _zipf(rng, 1_500, 300)
        lids = np.asarray(pair.lids)[keys % 2]
        first = pair.call(500, lids, keys)
        assert [c["mode"] for c in first] == ["resident"]
        assert first[0]["deltas"] == first[0]["uniques"]
        again = pair.call(700, lids, keys)
        assert again[0]["deltas"] == 0 and again[0]["delta_lanes"] == 8
        for call in range(3):
            for k in rng.choice(keys, 3):
                pair.reset(int(lids[keys == k][0]), int(k))
            order = rng.permutation(len(keys))
            chunks = pair.call(1_100, lids[order], keys[order])
            assert 1 <= chunks[0]["deltas"] <= 3
            pair.assert_lid_maps_equal()
    finally:
        pair.close()


@pytest.mark.parametrize("algo", ["tb", "sw"])
def test_one_limiter_streams_elect_like_reference(algo, monkeypatch):
    """One limiter, unit permits, chunks of 256 growing to 2048: uniform
    keys over a wide space elect words mode, Zipf keys the digest, and a
    stream that turns from one to the other switches mode chunk by chunk
    as the reference's does; every decision equals the oracle's."""
    for mod in (ref_storage_mod, gpu_mod):
        monkeypatch.setattr(mod, "_RELAY_CHUNK", 256)
        monkeypatch.setattr(mod, "_RELAY_CHUNK_MAX", 2048)
    rng = np.random.default_rng(33 if algo == "tb" else 34)
    pair = Pair(algo, CFG[algo][:1], num_slots=8192)
    lid = pair.lids[0]
    try:
        uniform = rng.permutation(np.r_[rng.integers(0, 6_000, 2_970),
                                        np.full(30, 7)])
        assert {c["mode"] for c in pair.call(900, lid, uniform)} == {"words"}
        zipf = _zipf(rng, 3_000, 300)
        assert {c["mode"] for c in pair.call(900, lid, zipf)} == {"relay"}
        mixed = np.r_[rng.integers(0, 6_000, 1_000), _zipf(rng, 3_000, 200)]
        modes = [c["mode"] for c in pair.call(1_300, lid, mixed)]
        assert modes[0] == "words" and modes[-1] == "relay"
    finally:
        pair.close()


@ON_HOST_INDEXES
def test_words_mode_past_uint16_counts(algo, host_parallel):
    """A limit of 70_000 (no count dtype fits): one limiter and then a lid
    array take words mode, a hot key repeated past every uint16 count, and
    decide like the reference and the oracle."""
    huge = dict(CFG[algo][0], max_permits=70_000)
    if algo == "tb":
        huge["refill_rate"] = 20_000.0
    pair = Pair(algo, [huge, CFG[algo][1]], num_slots=4096,
                host_parallel=host_parallel)
    rng = np.random.default_rng(37 if algo == "tb" else 38)
    try:
        assert pair.port.engine.counts_dtype() is None
        keys = rng.permutation(np.r_[np.full(71_000, 1),
                                     _zipf(rng, 1_000, 50)])
        assert [c["mode"] for c in pair.call(2_100, pair.lids[0],
                                             keys)] == ["words"]
        lids = np.where((keys == 1) | (keys % 2 == 0), pair.lids[0],
                        pair.lids[1])
        assert [c["mode"] for c in pair.call(700, lids, keys)] == ["words"]
    finally:
        pair.close()
