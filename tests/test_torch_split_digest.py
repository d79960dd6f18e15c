"""The split digest against the JAX package's, on the CPU.

- ``engine/native_index.py:split_layout`` (the shared ``rl_split_layout``
  in the port's library) against the reference's C path and its numpy
  form, on mixed chunks.
- ``ops/relay.py:*_relay_counts_split`` (on a CPU tensor, the plain
  version) against the JAX ``tb/sw_relay_counts_split``: the uint8 result
  and the whole state byte-equal, for tb and sw, uint8 and uint16 counts,
  with padding in both lanes and the clock rolling windows.  The card's
  path (singles re-encoded as count-1 words, one relay-kernel pass over
  both lanes) composed over the kernel's plain version gives the same
  bytes and state.
- The engine's split dispatch against the reference engine's, and its
  journal marks after the step (host and device journals).
- Storage pairs with ``host_parallel`` pinned equal: under
  ``set_link_profile(2e6, 0.05, 2e6)`` (the reference's split-forcing
  link, ``tests/test_relay.py``) the split engages on the same chunks in
  both, decisions equal the reference's and a profile-less storage's,
  and the state rows are byte-equal.
"""

import functools
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ratelimiter_tpu.core.config import RateLimitConfig as RefConfig
from ratelimiter_tpu.engine import device_rates as ref_rates
from ratelimiter_tpu.engine import native_index as ref_native
from ratelimiter_tpu.engine.engine import DeviceEngine as RefEngine
from ratelimiter_tpu.engine.state import LimiterTable as RefTable
from ratelimiter_tpu.ops import relay as ref_relay
from ratelimiter_tpu.ops.sliding_window import make_sw_packed as ref_sw_state
from ratelimiter_tpu.ops.token_bucket import make_tb_packed as ref_tb_state
from ratelimiter_tpu.storage.tpu import TpuBatchedStorage
from ratelimiter_tpu_torch import RateLimitConfig
from ratelimiter_tpu_torch.engine import native_index
from ratelimiter_tpu_torch.engine.engine import DeviceEngine
from ratelimiter_tpu_torch.engine.state import (
    DeviceSlotJournal,
    LimiterTable,
    SlotJournal,
    load_reference_state,
)
from ratelimiter_tpu_torch.ops import relay
from ratelimiter_tpu_torch.ops.sliding_window import make_sw_packed
from ratelimiter_tpu_torch.ops.token_bucket import make_tb_packed
from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage, _bucket_fine
from torch_reference_native import (  # noqa: F401 (autouse fixture)
    idle_reference_flushers,
    require_reference_native,
)

torch.set_num_threads(1)

CFG = {"tb": dict(max_permits=9, window_ms=900, refill_rate=4.0),
       "sw": dict(max_permits=9, window_ms=900, enable_local_cache=False)}
DTYPES = {"u8": (np.uint8, jnp.uint8, torch.uint8),
          "u16": (np.uint16, jnp.uint16, torch.uint16)}


def _chunk(rng, u: int, rb: int, num_slots: int, n: int):
    """A digest chunk's uniques (about 80% singletons, the rest counts up
    to the clamp) over distinct slots, and each request's unique index."""
    slots = rng.choice(num_slots, u, replace=False).astype(np.uint32)
    counts = np.where(rng.random(u) < 0.8, 1,
                      rng.integers(2, (1 << rb), u)).astype(np.uint32)
    uwords = (slots << np.uint32(rb + 1)) | (counts << np.uint32(1))
    return uwords, rng.integers(0, u, n).astype(np.int32)


def _padded(uwords, rb: int, uidx):
    """The storage's split lanes: the plane and the multi words padded to
    :func:`_bucket_fine` (0xFFFFFF / 0xFFFFFFFF), as ``_stream_relay``
    pads them."""
    s3, mwords, uidx2, n_s = native_index.split_layout(uwords, rb, uidx)
    s3p = np.full((_bucket_fine(n_s), 3), 0xFF, dtype=np.uint8)
    s3p[:n_s] = s3
    mw = np.full(_bucket_fine(len(uwords) - n_s), 0xFFFFFFFF,
                 dtype=np.uint32)
    mw[:len(mwords)] = mwords
    return s3p, mw, uidx2, n_s


def test_split_layout_matches_reference():
    """The port's binding against the reference's C path and its numpy
    form: equal planes, multi words, remapped indexes and singles counts,
    on a mixed chunk, an all-singles chunk and an empty one."""
    require_reference_native()
    rng = np.random.default_rng(9)
    rb = 8
    cases = [_chunk(rng, 50_000, rb, 1 << 22, 140_000)]
    slots = rng.permutation(1 << 16)[:3000].astype(np.uint32)
    cases.append(((slots << np.uint32(rb + 1)) | np.uint32(2),
                  rng.integers(0, 3000, 3000).astype(np.int32)))
    cases.append((np.zeros(0, np.uint32), np.zeros(0, np.int32)))
    for uwords, uidx in cases:
        got = native_index.split_layout(uwords.copy(), rb, uidx.copy())
        want_c = ref_native.split_layout(uwords.copy(), rb, uidx.copy())
        with mock.patch.object(ref_native, "_load_library", lambda: None):
            want_np = ref_native.split_layout(uwords.copy(), rb,
                                              uidx.copy())
        counts = (uwords >> np.uint32(1)) & np.uint32((1 << rb) - 1)
        assert got[3] == want_c[3] == want_np[3] == int((counts == 1).sum())
        for want in (want_c, want_np):
            for a, b in zip(got[:3], want[:3]):
                np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        native_index.split_layout(cases[0][0].astype(np.int64), rb,
                                  cases[0][1])


def _states(algo, num_slots):
    ref = (ref_tb_state if algo == "tb" else ref_sw_state)(num_slots)
    port = (make_tb_packed if algo == "tb" else make_sw_packed)(
        num_slots, "cpu")
    return ref, port


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("algo", ["tb", "sw"])
def test_relay_counts_split_matches_reference(algo, dtype):
    """Five steps over fresh chunks on a 2^14-slot table at rank_bits 8,
    the clock moving a window on and stepping back once: the port's split
    (plain on the CPU) and the JAX step give the same bytes and state, and
    so does the card's path composed over the kernel's plain version."""
    np_dt, jnp_dt, torch_dt = DTYPES[dtype]
    rng = np.random.default_rng(31 if algo == "tb" else 32)
    num_slots, rb = 1 << 14, 8
    ref_tab, port_tab = RefTable(), LimiterTable(device="cpu")
    lid = ref_tab.register(RefConfig(**CFG[algo]))
    assert port_tab.register(RateLimitConfig(**CFG[algo])) == lid
    ref_state, port_state = _states(algo, num_slots)
    kernel_state = port_state.clone()
    ref_step = jax.jit(functools.partial(
        ref_relay.tb_relay_counts_split if algo == "tb"
        else ref_relay.sw_relay_counts_split, rank_bits=rb,
        out_dtype=jnp_dt))
    port_step = (relay.tb_relay_counts_split if algo == "tb"
                 else relay.sw_relay_counts_split)
    plain_step = (relay.tb_relay_counts_plain if algo == "tb"
                  else relay.sw_relay_counts_plain)
    now = 10_000
    for step in range(5):
        now += -400 if step == 3 else int(rng.integers(100, 1_000))
        uwords, uidx = _chunk(rng, int(rng.integers(300, 1500)), rb,
                              num_slots, 2000)
        s3p, mw, _, n_s = _padded(uwords, rb, uidx)
        ref_state, want = ref_step(ref_state, ref_tab.device_arrays,
                                   jnp.asarray(s3p), jnp.asarray(mw),
                                   jnp.int32(lid), jnp.int64(now))
        s3t = torch.from_numpy(s3p)
        mwt = torch.from_numpy(mw.view(np.int32))
        got = port_step(port_state, port_tab.device_arrays, s3t, mwt, lid,
                        now, rank_bits=rb, out_dtype=torch_dt)
        card = relay._relay_counts_split_kernel(
            plain_step, kernel_state, port_tab.device_arrays, s3t, mwt, lid,
            now, rank_bits=rb, out_dtype=torch_dt)
        want = np.asarray(want)
        assert want.dtype == np.uint8
        assert len(want) == len(s3p) // 8 + len(mw) * np.dtype(np_dt).itemsize
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{step}")
        np.testing.assert_array_equal(card.numpy(), want, err_msg=f"{step}")
        for state in (port_state, kernel_state):
            np.testing.assert_array_equal(state.numpy(),
                                          np.asarray(ref_state))
        bits = np.unpackbits(want[:len(s3p) // 8])
        assert 0 < bits[:n_s].sum() and not bits[n_s:].any()


@pytest.mark.parametrize("journal", ["host", "device"])
@pytest.mark.parametrize("algo", ["tb", "sw"])
def test_engine_split_dispatch_matches_reference(algo, journal):
    """The engine's split dispatch against the reference engine's on one
    loaded state: equal bytes and state over three steps, and the journal
    marks every single's and multi's slot, padding dropped, once the step
    is enqueued."""
    rng = np.random.default_rng(41 if algo == "tb" else 42)
    ref_table = RefTable()
    lid = ref_table.register(RefConfig(**CFG[algo]))
    ref = RefEngine(4096, ref_table)
    port = DeviceEngine(4096, LimiterTable(device="cpu"), device="cpu")
    load_reference_state(
        port, np.asarray(ref.sw_packed), np.asarray(ref.tb_packed),
        [ref_table.host_policy(l) for l in range(len(ref_table))])
    port.journal = (SlotJournal(4096) if journal == "host"
                    else DeviceSlotJournal(4096, device="cpu"))
    rb = port.rank_bits
    assert rb == ref.rank_bits
    now = 50_000
    for step in range(3):
        now += 700
        uwords, uidx = _chunk(rng, 600, rb, 4096, 900)
        s3p, mw, _, _ = _padded(uwords, rb, uidx)
        dt = np.uint8 if step % 2 else np.uint16
        want = np.asarray(getattr(ref, f"{algo}_relay_counts_split_dispatch")(
            s3p, mw, lid, now, dt))
        got = getattr(port, f"{algo}_relay_counts_split_dispatch")(
            s3p, mw, lid, now, dt).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"step {step}")
        np.testing.assert_array_equal(
            getattr(port, f"{algo}_packed").numpy(),
            np.asarray(getattr(ref, f"{algo}_packed")))
        dirty, _, _ = port.journal.drain()
        np.testing.assert_array_equal(
            np.sort(dirty[algo]),
            np.sort((uwords >> np.uint32(rb + 1)).astype(np.int64)))


class SplitPair:
    """A profiled reference and port storage and a profile-less port
    storage on one clock, with the same limiter, the same host index and
    the same rates dict for the elections."""

    def __init__(self, algo: str, host_parallel: int, num_slots=1 << 16):
        self.now = [1_000_000]
        clock = lambda: self.now[0]  # noqa: E731
        cfg = dict(max_permits=20, window_ms=60_000, refill_rate=5.0) \
            if algo == "tb" else dict(max_permits=20, window_ms=60_000,
                                      enable_local_cache=False)
        self.ref = TpuBatchedStorage(num_slots=num_slots, clock_ms=clock,
                                     host_parallel=host_parallel)
        self.port = GpuBatchedStorage(num_slots=num_slots, clock_ms=clock,
                                      device="cpu",
                                      host_parallel=host_parallel)
        self.plain = GpuBatchedStorage(num_slots=num_slots, clock_ms=clock,
                                       device="cpu",
                                       host_parallel=host_parallel)
        self.lid = self.ref.register_limiter(algo, RefConfig(**cfg))
        for st in (self.port, self.plain):
            assert st.register_limiter(
                algo, RateLimitConfig(**cfg)) == self.lid
        for st in (self.ref, self.port):
            st._device_rates_obj = dict(ref_rates.FALLBACK_RATES)
            # Slow both ways: the per-unique wire dominates and the split's
            # 3 B up and a bit back win.
            st.set_link_profile(2e6, 0.05, 2e6)

    def close(self):
        for st in (self.ref, self.port, self.plain):
            st.close()


@pytest.mark.parametrize("algo,host_parallel",
                         [("tb", 0), ("sw", 0), ("tb", 4)])
def test_split_engages_like_reference(algo, host_parallel):
    """The reference's split scenario (``tests/test_relay.py:
    test_split_digest_mode_parity_and_engagement``): 40_000 requests a
    pass, ~0.85 unique a request with a few hot keys, three passes.  Each
    chunk takes the reference's mode (split where it split), the singles
    counts are equal, decisions equal the reference's and the
    profile-less port's, and the state is byte-equal after each pass."""
    require_reference_native()
    rng = np.random.default_rng(11)
    n = 40_000
    ids = np.concatenate([rng.integers(0, 30_000, n - 2_000),
                          rng.integers(0, 50, 2_000)]).astype(np.int64)
    rng.shuffle(ids)
    pair = SplitPair(algo, host_parallel)
    names = {"split": "split", "digest": "relay", "bits": "words"}
    engaged = 0
    try:
        for _ in range(3):
            pair.ref.stream_stats = stats = []
            want = pair.ref.acquire_stream_ids(algo, pair.lid, ids)
            pair.ref.stream_stats = None
            got = pair.port.acquire_stream_ids(algo, pair.lid, ids)
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(
                pair.plain.acquire_stream_ids(algo, pair.lid, ids), want)
            chunks = pair.port.last_stream_chunks
            assert [rec["mode"] for rec in chunks] == [
                names[r["mode"]] for r in stats]
            assert [rec.get("singles") for rec in chunks] == [
                r.get("singles") for r in stats]
            assert all(rec["mode"] != "split"
                       for rec in pair.plain.last_stream_chunks)
            engaged += sum(rec["mode"] == "split" for rec in chunks)
            packed = f"{algo}_packed"
            np.testing.assert_array_equal(
                getattr(pair.port.engine, packed).numpy(),
                np.asarray(getattr(pair.ref.engine, packed)))
            pair.now[0] += 10_000
        split = next(r for r in chunks if r["mode"] == "split")
        assert split["singles"] > split["uniques"] * 0.3
    finally:
        pair.close()
    assert engaged > 0
