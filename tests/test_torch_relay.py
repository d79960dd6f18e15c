"""The port's relay stream route against the JAX package's, on the CPU.

- The plain relay step (what a CPU tensor takes; the CUDA kernel is held
  against it on the card by ``chip_smoke.py``) is byte-equal to the JAX
  package's composed step and to its Pallas kernel in interpret mode:
  counts and the whole packed state after every step.
- The port's copy of the C slot index binding gives what the reference's
  gives on the same keys.
- ``GpuBatchedStorage(device="cpu").acquire_stream_ids`` decides like
  ``TpuBatchedStorage.acquire_stream_ids`` and like ``semantics/oracle.py``,
  through evictions, resets, window rollover and a backward clock step.

Every quantity is an integer, so every comparison is exact.
"""

import functools
import subprocess

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ratelimiter_tpu.algorithms import (
    SlidingWindowRateLimiter as RefSW,
    TokenBucketRateLimiter as RefTB,
)
from ratelimiter_tpu.core.config import RateLimitConfig as RefConfig
from ratelimiter_tpu.engine import native_index as ref_native
from ratelimiter_tpu.engine.state import LimiterTable as RefTable
from ratelimiter_tpu.metrics import MeterRegistry as RefRegistry
from ratelimiter_tpu.ops import relay as ref_relay
from ratelimiter_tpu.ops.pallas import relay_step as ref_fused
from ratelimiter_tpu.ops.sliding_window import make_sw_packed as ref_sw_state
from ratelimiter_tpu.ops.token_bucket import make_tb_packed as ref_tb_state
from ratelimiter_tpu.storage import tpu as ref_storage_mod
from ratelimiter_tpu.storage.tpu import TpuBatchedStorage
from ratelimiter_tpu_torch import RateLimitConfig
from ratelimiter_tpu_torch.algorithms import (
    SlidingWindowRateLimiter,
    TokenBucketRateLimiter,
)
from ratelimiter_tpu_torch.engine import native_index
from ratelimiter_tpu_torch.engine.state import LimiterTable
from ratelimiter_tpu_torch.metrics import MeterRegistry
from ratelimiter_tpu_torch.ops import relay
from ratelimiter_tpu_torch.ops.cuda import build, relay_step
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

POLICY = dict(max_permits=9, window_ms=900, refill_rate=4.0)


# -- the plain relay step against the JAX package -----------------------------
def _tables():
    ref = RefTable()
    lid = ref.register(RefConfig(**POLICY))
    port = LimiterTable(device="cpu")
    assert port.register(RateLimitConfig(**POLICY)) == lid
    return ref.device_arrays, port.device_arrays, lid


def _uwords(rng, s_rows, u, rank_bits, clamp):
    """u words (slot | count), slots unique and sorted, a padding tail;
    with ``clamp`` two lanes carry the count clamp sentinel."""
    n_real = int(rng.integers(1, u))
    slots = np.sort(rng.choice(s_rows, n_real, replace=False))
    counts = rng.integers(1, 9, n_real)
    if clamp:
        counts[rng.integers(0, n_real, 2)] = (1 << rank_bits) - 1
    words = np.full(u, 0xFFFFFFFF, dtype=np.uint32)
    words[:n_real] = ((slots.astype(np.uint32) << np.uint32(rank_bits + 1))
                      | (counts.astype(np.uint32) << np.uint32(1)))
    return words


class _Stepper:
    """One state, stepped by the port's plain relay step or by a JAX
    function of the reference's signature."""

    def __init__(self, algo, s_rows, fn=None):
        self.algo, self.fn = algo, fn
        if fn is None:
            self.state = (make_tb_packed if algo == "tb"
                          else make_sw_packed)(s_rows, "cpu")
        else:
            self.state = (ref_tb_state if algo == "tb"
                          else ref_sw_state)(s_rows)

    def step(self, tables, lid, words, now, rank_bits, dtype):
        ref_tab, port_tab = tables
        if self.fn is not None:
            self.state, counts = self.fn(self.state, ref_tab,
                                         jnp.asarray(words), jnp.int32(lid),
                                         jnp.int64(now))
            return np.asarray(counts)
        step = relay.tb_relay_counts if self.algo == "tb" else \
            relay.sw_relay_counts
        counts = step(self.state, port_tab,
                      torch.from_numpy(words.view(np.int32).copy()), lid,
                      now, rank_bits=rank_bits,
                      out_dtype=torch.uint8 if dtype == np.uint8
                      else torch.uint16)
        return counts.numpy()

    def rows(self):
        return (self.state.numpy() if self.fn is None
                else np.asarray(self.state))


@pytest.mark.parametrize("algo", ["tb", "sw"])
@pytest.mark.parametrize("s_rows,dtype", [(512, np.uint8),
                                          (1024, np.uint16)])
def test_plain_relay_step_matches_composed_and_pallas(algo, s_rows, dtype):
    """Sorted words through the port, the composed XLA step and the Pallas
    kernel (interpret mode); unsorted words, padding lanes among them,
    through the port and the composed step, from a negative ``now`` on.
    Counts and the whole state agree after every step."""
    rng = np.random.default_rng(s_rows + (algo == "sw"))
    rb = 31 - s_rows.bit_length()
    ref_tab, port_tab, lid = _tables()
    tables = (ref_tab, port_tab)
    jdt = jnp.uint8 if dtype == np.uint8 else jnp.uint16
    base = ref_relay.tb_relay_counts if algo == "tb" else \
        ref_relay.sw_relay_counts
    fused = ref_fused.tb_relay_counts_fused if algo == "tb" else \
        ref_fused.sw_relay_counts_fused
    composed = jax.jit(functools.partial(base, rank_bits=rb, out_dtype=jdt))
    sorted_trio = [
        _Stepper(algo, s_rows),
        _Stepper(algo, s_rows, composed),
        _Stepper(algo, s_rows, jax.jit(functools.partial(
            fused, rank_bits=rb, out_dtype=jdt, interpret=True))),
    ]
    unsorted_pair = [_Stepper(algo, s_rows), _Stepper(algo, s_rows,
                                                      composed)]
    now_sorted, now_unsorted = 1, -250
    for step in range(5):
        u = 512 if s_rows == 512 else int(rng.choice([512, 1024]))
        words = _uwords(rng, s_rows, u, rb, clamp=step % 2 == 0)
        now_sorted += int(rng.integers(0, 1300))
        got = [s.step(tables, lid, words, now_sorted, rb, dtype)
               for s in sorted_trio]
        shuffled = rng.permutation(words)
        got += [s.step(tables, lid, shuffled, now_unsorted, rb, dtype)
                for s in unsorted_pair]
        now_unsorted += int(rng.integers(100, 1300))
        for want, other, name in ((got[1], got[0], "port"),
                                  (got[1], got[2], "pallas"),
                                  (got[4], got[3], "port unsorted")):
            assert other.dtype == dtype
            np.testing.assert_array_equal(other, want,
                                          err_msg=f"{name} step {step}")
        want_rows = sorted_trio[1].rows()
        np.testing.assert_array_equal(sorted_trio[0].rows(), want_rows)
        np.testing.assert_array_equal(sorted_trio[2].rows(), want_rows)
        np.testing.assert_array_equal(unsorted_pair[0].rows(),
                                      unsorted_pair[1].rows())


def test_denied_sliding_window_lanes_write_rolled_rows():
    """A sliding-window lane that allows nothing still writes its row
    rolled to ``now``: here the previous window's count has expired while
    the current window is full, so the written row drops it."""
    s_rows, rb = 512, 21
    ref_tab, port_tab, lid = _tables()
    slots = np.arange(100, dtype=np.uint32) << np.uint32(rb + 1)
    one = np.full(512, 0xFFFFFFFF, dtype=np.uint32)
    one[:100] = slots | np.uint32(1 << 1)
    many = one.copy()
    many[:100] = slots | np.uint32(((1 << rb) - 1) << 1)
    steppers = [
        _Stepper("sw", s_rows),
        _Stepper("sw", s_rows, jax.jit(functools.partial(
            ref_relay.sw_relay_counts, rank_bits=rb))),
        _Stepper("sw", s_rows, jax.jit(functools.partial(
            ref_fused.sw_relay_counts_fused, rank_bits=rb, interpret=True))),
    ]
    # Window 900 ms: one request at 1000 (window 900), a full window at
    # 1850 (window 1800; the count from 1000 lives until 1900), then at
    # 1950 every lane is denied and the expired count leaves the rows.
    for words, now, allowed in ((one, 1_000, 1), (many, 1_850, 9),
                                (many, 1_950, 0)):
        got = [st.step((ref_tab, port_tab), lid, words, now, rb, np.uint8)
               for st in steppers]
        assert (got[0][:100] == allowed).all()
        for other in got[1:]:
            np.testing.assert_array_equal(got[0], other)
        rows = steppers[0].rows()
        for st in steppers[1:]:
            np.testing.assert_array_equal(rows, st.rows())
    assert (rows[:100, 3] == 0).all()


# -- the C slot index binding -------------------------------------------------
def test_native_index_copy_matches_reference():
    """Same keys through the port's and the reference's bindings of the C
    index, with eviction churn and pinned slots: uniques assignment,
    slot sort, decision rebuild, scalar and batch assigns.  The port's
    library is built into build/native/ and nothing in native/ changes."""
    require_reference_native()
    rng = np.random.default_rng(7)
    s = 256
    rb = 31 - s.bit_length()
    ref, port = ref_native.NativeSlotIndex(s), native_index.NativeSlotIndex(s)
    for step in range(8):
        keys = (rng.zipf(1.1, 300) - 1) % 2000   # more keys than slots
        pinned = set(rng.choice(s, 5).tolist()) if step % 2 else None
        want = ref.assign_batch_ints_uniques(keys, 3, rb, pinned=pinned,
                                             hold_pins=True)
        got = port.assign_batch_ints_uniques(keys, 3, rb, pinned=pinned,
                                             hold_pins=True)
        assert len(want[3]) > 0 or step == 0
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        held = (want[0] >> np.uint32(rb + 1)).astype(np.int32)
        ref.unpin_batch(held)
        port.unpin_batch(held)
        uw_r, ui_r = want[0].copy(), want[1].copy()
        uw_p, ui_p = want[0].copy(), want[1].copy()
        ref_native.sort_uniques(uw_r, rb, ui_r)
        native_index.sort_uniques(uw_p, rb, ui_p)
        np.testing.assert_array_equal(uw_p, uw_r)
        np.testing.assert_array_equal(ui_p, ui_r)
        counts = rng.integers(0, 10, len(uw_r)).astype(
            np.uint8 if step % 2 else np.uint16)
        np.testing.assert_array_equal(
            native_index.relay_decide(counts, ui_p, want[2]),
            ref_native.relay_decide(counts, ui_r, want[2]))
        ids = rng.integers(0, 400, 50)
        for g, w in zip(port.assign_batch_ints(ids, 4),
                        ref.assign_batch_ints(ids, 4)):
            np.testing.assert_array_equal(g, w)
        for _ in range(40):
            key = (5, f"user{int(rng.integers(0, 300))}")
            assert port.assign(key) == ref.assign(key)
        victim = (5, f"user{int(rng.integers(0, 300))}")
        assert port.get(victim) == ref.get(victim)
        assert port.remove(victim) == ref.remove(victim)
        assert len(port) == len(ref)
    lib = native_index.library_path()
    assert lib.parent == native_index.BUILD_DIR and lib.exists()
    assert native_index.BUILD_DIR.parts[-2:] == ("build", "native")
    status = subprocess.run(["git", "status", "--porcelain", "native"],
                            cwd=native_index.REPO, capture_output=True,
                            text=True, timeout=60)
    assert status.returncode == 0 and status.stdout == ""


# -- the stream route through the storage -------------------------------------
CASES = {
    "tb": dict(max_permits=20, window_ms=2_000, refill_rate=5.0),
    "sw": dict(max_permits=12, window_ms=2_000, enable_local_cache=False),
}


def _limiter(ref: bool, algo, storage, clock):
    if ref:
        cfg, reg = RefConfig(**CASES[algo]), RefRegistry()
        return (RefTB(storage, cfg, reg) if algo == "tb"
                else RefSW(storage, cfg, reg, clock_ms=clock))
    cfg, reg = RateLimitConfig(**CASES[algo]), MeterRegistry()
    return (TokenBucketRateLimiter(storage, cfg, reg) if algo == "tb"
            else SlidingWindowRateLimiter(storage, cfg, reg, clock_ms=clock))


@pytest.fixture
def small_chunks(monkeypatch):
    """Both storages cut streams into 256 requests, then 1024 at most; the
    port sorts uniques from 64 up."""
    for mod in (ref_storage_mod, gpu_mod):
        monkeypatch.setattr(mod, "_RELAY_CHUNK", 256)
        monkeypatch.setattr(mod, "_RELAY_CHUNK_MAX", 1024)
    monkeypatch.setattr(gpu_mod, "_SORT_UNIQUES_MIN", 64)


def _zipf(rng, n, n_keys):
    return ((rng.zipf(1.1, n) - 1) % n_keys).astype(np.int64)


@pytest.mark.parametrize("algo", ["tb", "sw"])
def test_stream_matches_reference_storage(algo, small_chunks):
    """Zipf streams over more keys than slots (evictions), mixed with
    try_acquire_ids and try_acquire on the same limiter, resets between
    streams, the clock crossing windows and stepping back once:
    decisions, available permits and each key's packed row agree."""
    require_reference_native()
    clock = {"t": 1_700_000_000_000}
    ref_st = TpuBatchedStorage(num_slots=512, clock_ms=lambda: clock["t"],
                               observability=False, host_parallel=0)
    port_st = GpuBatchedStorage(num_slots=512, clock_ms=lambda: clock["t"],
                                device="cpu", host_parallel=0)
    try:
        assert port_st.engine.rank_bits == ref_st.engine.rank_bits
        ref = _limiter(True, algo, ref_st, lambda: clock["t"])
        port = _limiter(False, algo, port_st, lambda: clock["t"])
        rng = np.random.default_rng(11 if algo == "tb" else 12)
        seen = set()
        for call in range(9):
            clock["t"] += -3_000 if call == 5 else int(rng.integers(0, 1_500))
            if call % 3 == 0:
                ids = _zipf(rng, 2_500, 800)
                got = port.try_acquire_stream_ids(ids)
                want = ref.try_acquire_stream_ids(ids)
            elif call % 3 == 1:
                ids = _zipf(rng, 300, 800)
                permits = rng.integers(1, 4, 300)
                got = port.try_acquire_ids(ids, permits)
                want = ref.try_acquire_ids(ids, permits)
            else:
                ids = _zipf(rng, 20, 800)
                got = [port.try_acquire(f"user{k}") for k in ids]
                want = [ref.try_acquire(f"user{k}") for k in ids]
            np.testing.assert_array_equal(got, want, err_msg=f"call {call}")
            seen.update(int(k) for k in ids)
            for k in rng.choice(sorted(seen), 3):
                if call % 2:
                    port.reset(int(k))
                    ref.reset(int(k))
                assert (port.get_available_permits(int(k))
                        == ref.get_available_permits(int(k)))
        assert port_st.backward_clamps == ref_st.backward_clamps > 0
        assert len(seen) > 512           # more keys than slots: evictions
        chunks = port_st.last_stream_chunks
        assert len(chunks) == 4 and max(c["uniques"] for c in chunks) >= 64
        lid = port._lid
        for k in sorted(seen):
            r_slot = ref_st._index[algo].get((lid, k))
            p_slot = port_st._index[algo].get((lid, k))
            assert (r_slot is None) == (p_slot is None), k
            if r_slot is not None:
                np.testing.assert_array_equal(
                    port_st.engine.read_rows(algo, [p_slot]),
                    ref_st.engine.read_rows(algo, [r_slot]), err_msg=str(k))
    finally:
        ref_st.close()
        port_st.close()


@pytest.mark.parametrize("algo", ["tb", "sw"])
def test_stream_decisions_match_oracle(algo, small_chunks):
    """With room for every key, each stream decision equals the oracle's
    in arrival order at the storage's (clamped) timestamp, through window
    rollover, a reset and a backward clock step."""
    clock = {"t": 1_700_000_000_000}
    storage = GpuBatchedStorage(num_slots=1024, clock_ms=lambda: clock["t"],
                                device="cpu")
    try:
        lim = _limiter(False, algo, storage, lambda: clock["t"])
        cfg = RateLimitConfig(**CASES[algo])
        oracle = (TokenBucketOracle(cfg) if algo == "tb"
                  else SlidingWindowOracle(cfg))
        rng = np.random.default_rng(21)
        stamp = 0
        for call in range(6):
            clock["t"] += -1_000 if call == 4 else int(rng.integers(300, 2_500))
            stamp = max(stamp, clock["t"])
            if call == 3:
                lim.reset(7)
                oracle.reset(7, stamp)
            ids = _zipf(rng, 1_500, 600)
            got = lim.try_acquire_stream_ids(ids)
            want = [oracle.try_acquire(int(k), 1, stamp).allowed
                    for k in ids]
            np.testing.assert_array_equal(got, want, err_msg=f"call {call}")
            assert 0 < got.sum() < len(ids)
    finally:
        storage.close()


def test_unported_stream_modes_raise():
    """The calls this route once refused are served now and decide like
    the reference: a per-request lid array (the relay's resident digest)
    and a permits lane (the weighted relay), beside the unit-permit
    relay."""
    require_reference_native()
    clock = {"t": 1_700_000_000_000}
    cfg = dict(max_permits=5, window_ms=1_000, refill_rate=1.0)
    ref_st = TpuBatchedStorage(num_slots=1024, clock_ms=lambda: clock["t"],
                               observability=False, host_parallel=0)
    storage = GpuBatchedStorage(num_slots=1024, clock_ms=lambda: clock["t"],
                                device="cpu", host_parallel=0)
    try:
        ref = RefTB(ref_st, RefConfig(**cfg), RefRegistry())
        lim = TokenBucketRateLimiter(storage, RateLimitConfig(**cfg),
                                     MeterRegistry())
        ids = np.arange(10) % 4
        for call in range(3):
            clock["t"] += 400
            want = ref_st.acquire_stream_ids("tb", np.full(10, ref._lid),
                                             ids)
            got = storage.acquire_stream_ids("tb", np.full(10, lim._lid),
                                             ids)
            np.testing.assert_array_equal(got, want)
            assert storage.last_stream_chunks[0]["mode"] == "resident"
            permits = np.ones(10, dtype=np.int64) + call
            np.testing.assert_array_equal(
                lim.try_acquire_stream_ids(ids, permits),
                ref.try_acquire_stream_ids(ids, permits))
            assert storage.last_stream_chunks[0]["mode"] == "weighted_coal"
            np.testing.assert_array_equal(lim.try_acquire_stream_ids(ids),
                                          ref.try_acquire_stream_ids(ids))
    finally:
        ref_st.close()
        storage.close()


def test_relay_kernel_wrapper_refuses_cpu_tensors(monkeypatch, tmp_path):
    """The kernel takes CUDA tensors only and raises before any build or
    launch; it is built for Hopper with the other kernels."""
    _, table, lid = _tables()
    words = torch.full((8,), -1, dtype=torch.int32)
    for fn, lanes in ((relay_step.tb_relay_counts, 4),
                      (relay_step.sw_relay_counts, 6)):
        with pytest.raises(ValueError, match="CUDA"):
            fn(torch.zeros((16, lanes), dtype=torch.int32), table, words,
               lid, 0, rank_bits=26)
    assert relay_step.launches == 0
    assert "relay_step" in build.KERNELS
    monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
    cmd = build.nvcc_command("relay_step", tmp_path / "lib.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[-1].endswith("relay_step.cu")
