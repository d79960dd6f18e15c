"""The steps' write-back: the port's plain version against the JAX step.

The port's steps build and store their new rows in one call,
``tb_writeback`` / ``sw_writeback`` (a kernel on the card, the plain
version here).  Each case below drives staged batches through both
engines' ``micro_staged_dispatch`` and holds the fused outputs and the
whole packed state byte-equal after every batch: duplicate keys, one key
over the whole batch, an all-padding batch, pre-rejected lanes, weightless
(zero-permit) lanes inside live segments, window rollover and ``now``
stepping backward.  One more test counts what a step calls, and one
holds a one-lane sliding-window batch and a one-key stream to the
reference.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ratelimiter_tpu.core.config import RateLimitConfig as RefConfig
from ratelimiter_tpu.engine.engine import DeviceEngine as RefEngine
from ratelimiter_tpu.engine.state import LimiterTable as RefTable
from ratelimiter_tpu.ops import sliding_window as ref_sw
from ratelimiter_tpu.semantics.oracle import SlidingWindowOracle
from ratelimiter_tpu_torch import RateLimitConfig
from ratelimiter_tpu_torch.algorithms import SlidingWindowRateLimiter
from ratelimiter_tpu_torch.engine.engine import DeviceEngine
from ratelimiter_tpu_torch.engine.state import (
    LimiterTable,
    load_reference_state,
)
from ratelimiter_tpu_torch.metrics import MeterRegistry
from ratelimiter_tpu_torch.ops import scatter, sliding_window, token_bucket
from ratelimiter_tpu_torch.ops.cuda import block_scatter
from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage
from torch_reference_native import idle_reference_flushers  # noqa: F401

torch.set_num_threads(1)

NUM_SLOTS = 256
BUCKET = 64
POLICIES = {  # lid -> (algo, config kwargs)
    1: ("sw", dict(max_permits=10, window_ms=1_000)),
    2: ("tb", dict(max_permits=10, window_ms=1_000, refill_rate=5.0)),
}
LID = {"sw": 1, "tb": 2}
MAXP = 10
STEADY = [10_000, 10_300, 10_600, 10_900]


def _dups(rng, n):
    return (rng.zipf(1.3, n) - 1) % 8 * 3, rng.integers(1, MAXP + 1, n)


def _one_key(rng, n):
    return np.full(n, 17), rng.integers(1, 4, n)


def _pre_rejected(rng, n):
    slots, permits = _dups(rng, n)
    return slots, np.where(rng.random(n) < 0.4, MAXP + 1 + rng.integers(
        0, 5, n), permits)


def _weightless(rng, n):
    slots, permits = _dups(rng, n)
    return slots, np.where(rng.random(n) < 0.3, 0, permits)


# name -> (slots and permits of n live lanes, live lanes, `now` per batch)
CASES = {
    "duplicates": (_dups, BUCKET - 7, STEADY),
    "one-key": (_one_key, BUCKET, STEADY),
    "all-padding": (_dups, 0, STEADY),
    "pre-rejected": (_pre_rejected, BUCKET - 3, STEADY),
    "weightless-in-live": (_weightless, BUCKET, STEADY),
    "rollover": (_dups, BUCKET - 1, [10_900, 11_000, 11_999, 12_000, 14_500]),
    "backward": (_dups, BUCKET - 5, [20_400, 19_800, 20_100, 0, -250]),
}


def _engines():
    ref_table = RefTable()
    for lid in sorted(POLICIES):
        assert ref_table.register(RefConfig(**POLICIES[lid][1])) == lid
    ref = RefEngine(NUM_SLOTS, ref_table)
    port = DeviceEngine(NUM_SLOTS, LimiterTable(device="cpu"), device="cpu")
    load_reference_state(
        port, np.asarray(ref.sw_packed), np.asarray(ref.tb_packed),
        [ref_table.host_policy(l) for l in range(len(ref_table))])
    return ref, port


def _staged(algo, slots, permits, now):
    staged = np.empty((4, BUCKET), dtype=np.int64)
    staged[0], staged[1], staged[2] = -1, 0, 1
    n = len(slots)
    staged[0, :n], staged[1, :n], staged[2, :n] = slots, LID[algo], permits
    staged[3, 0] = now
    return staged


def _step_both(ref, port, algo, staged, n):
    ref_out = np.asarray(ref.micro_staged_dispatch(algo, staged.copy(), n))
    port_out = port.micro_staged_dispatch(algo, staged.copy(), n).numpy()
    np.testing.assert_array_equal(port_out, ref_out)
    packed = "sw_packed" if algo == "sw" else "tb_packed"
    np.testing.assert_array_equal(getattr(port, packed).numpy(),
                                  np.asarray(getattr(ref, packed)))
    return ref_out


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("algo", ["sw", "tb"])
def test_writeback_state_byte_equal_to_reference_step(algo, case):
    make, n, nows = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    ref, port = _engines()
    # Warm the slots the case touches, so its rows have history.
    warm_slots, warm_permits = _dups(rng, BUCKET)
    _step_both(ref, port, algo,
               _staged(algo, warm_slots, warm_permits, nows[0] - 200),
               BUCKET)
    allowed = 0
    for now in nows:
        slots, permits = make(rng, n)
        out = _step_both(ref, port, algo, _staged(algo, slots, permits, now),
                         n)
        allowed += int((out[0, :n] & 1).sum())
    packed = "sw_packed" if algo == "sw" else "tb_packed"
    assert np.asarray(getattr(ref, packed)).any()
    if n:
        assert allowed > 0


@pytest.mark.parametrize("algo", ["sw", "tb"])
def test_step_writes_back_once_and_never_scatters(algo, monkeypatch):
    """A micro step stores its rows with one write-back call and no call
    of the row scatter (whose kernel serves resets and row writes only)."""
    calls = {"writeback": 0, "scatter": 0}
    mod = sliding_window if algo == "sw" else token_bucket
    plain = getattr(mod, f"{algo}_writeback_plain")

    def counted_writeback(*args):
        calls["writeback"] += 1
        return plain(*args)

    def counted_scatter(*args):
        calls["scatter"] += 1
        raise AssertionError("a step called the row scatter")

    monkeypatch.setattr(mod, f"{algo}_writeback_plain", counted_writeback)
    for owner in (scatter, mod, block_scatter):
        monkeypatch.setattr(owner, "scatter_rows", counted_scatter)
    rng = np.random.default_rng(5)
    ref, port = _engines()
    for i, now in enumerate(STEADY):
        slots, permits = _dups(rng, BUCKET - i)
        _step_both(ref, port, algo, _staged(algo, slots, permits, now),
                   BUCKET - i)
        assert calls == {"writeback": i + 1, "scatter": 0}
    assert block_scatter.tb_writeback_launches == 0
    assert block_scatter.sw_writeback_launches == 0


def test_one_lane_sliding_window_rows_encode():
    """A one-lane sliding-window batch for one tenant (0-d limiter id) and
    a one-key sliding-window stream both broadcast the window start to a
    one-element column of stride 0; the row codec once failed to view it
    as i32 pairs and raised on the CPU.  Both now match the reference."""
    ref, port = _engines()
    ref_packed, step = ref.sw_packed, jax.jit(ref_sw.sw_step_p)
    for now in (5_000, 5_400, 6_100):
        ref_packed, ref_out = step(
            ref_packed, ref.table.device_arrays, jnp.asarray([9], jnp.int32),
            jnp.asarray(LID["sw"], jnp.int32), jnp.asarray([3]),
            jnp.asarray(now, jnp.int64))
        port_out = sliding_window.sw_step_p(
            port.sw_packed, port.table.device_arrays, torch.tensor([9]),
            torch.tensor(LID["sw"]), torch.tensor([3]), now)
        for got, want in zip(port_out, ref_out):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(port.sw_packed.numpy(),
                                      np.asarray(ref_packed))

    cfg = dict(max_permits=10, window_ms=1_000)
    clock = {"t": 50_000}
    storage = GpuBatchedStorage(num_slots=64, device="cpu",
                                clock_ms=lambda: clock["t"])
    try:
        limiter = SlidingWindowRateLimiter(
            storage, RateLimitConfig(**cfg), MeterRegistry(),
            clock_ms=lambda: clock["t"])
        oracle = SlidingWindowOracle(RefConfig(**cfg))
        for dt in (0, 100, 300, 1_200):
            clock["t"] += dt
            want = [oracle.try_acquire(7, 1, clock["t"]).allowed
                    for _ in range(6)]
            np.testing.assert_array_equal(
                limiter.try_acquire_stream_ids(np.full(6, 7)), want)
    finally:
        storage.close()
