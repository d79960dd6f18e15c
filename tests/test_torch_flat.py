"""The port's flat sorted step and its K-step scan against the JAX
package's, on the CPU.

Both engines start from the same state (the reference's, carried over
with ``load_reference_state``); the same host lanes go through
``*_flat_dispatch`` / ``*_scan_dispatch`` on both (the reference's jitted
XLA steps, as its own tests run them on the CPU), and the packed allow
bits and the whole packed state must be byte-equal after every step.
Lanes: a scalar limiter id or a lane of them; unit permits, uint8 permits
and int32 permits with 0 and above-``max_permits`` values; -1 slots in the
middle of a batch; window rollover and ``now`` moving backward.

Negative permits are held equal for the sliding window only.  For the
token bucket they break the solver's contract (``w >= 0``), and the
reference decides them two ways: its XLA solver iterates on the negative
weights, its Pallas solver clips them to 0 (``ROADMAP.md`` C4).

Every quantity is an integer, so every comparison is exact.
"""

import zlib

import numpy as np
import pytest
import torch

from ratelimiter_tpu.core.config import RateLimitConfig as RefConfig
from ratelimiter_tpu.engine import native_index as ref_native
from ratelimiter_tpu.engine.engine import DeviceEngine as RefEngine
from ratelimiter_tpu.engine.state import LimiterTable as RefTable
from ratelimiter_tpu_torch.engine import native_index
from ratelimiter_tpu_torch.engine.engine import DeviceEngine
from ratelimiter_tpu_torch.engine.state import (
    LimiterTable,
    load_reference_state,
)
from ratelimiter_tpu_torch.ops import flat
from torch_reference_native import (  # noqa: F401 (autouse fixture)
    idle_reference_flushers,
    require_reference_native,
)

torch.set_num_threads(1)


NUM_SLOTS = 512
LANES = 256
POLICIES = {  # lid -> (algo, config kwargs)
    1: ("sw", dict(max_permits=10, window_ms=1_000)),
    2: ("sw", dict(max_permits=40, window_ms=2_000)),
    3: ("tb", dict(max_permits=30, window_ms=2_000, refill_rate=10.0)),
    4: ("tb", dict(max_permits=5, window_ms=1_000, refill_rate=2.5)),
}
LIDS = {"sw": [1, 2], "tb": [3, 4]}
# Window rollover (1 s windows), a backward step, and a jump past every
# window.
NOW = [11_000, 11_600, 10_700, 12_050, 75_000]
INT32 = np.iinfo(np.int32)


def _seed(*parts) -> int:
    return zlib.crc32(repr(parts).encode())


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


def _assert_state_equal(ref, port, algo, msg):
    want = np.asarray(ref.sw_packed if algo == "sw" else ref.tb_packed)
    got = (port.sw_packed if algo == "sw" else port.tb_packed).numpy()
    np.testing.assert_array_equal(got, want, err_msg=msg)


def _lanes(rng, algo, shape, lid_mode, permits_kind):
    """Slots over 48 keys with -1 lanes scattered through the batch,
    limiter ids (a slot is one (limiter, key), so a lane of ids follows
    the slot) and permits of one kind."""
    slots = rng.integers(0, 48, shape).astype(np.int32)
    slots[rng.random(shape) < 0.1] = -1
    lids = (LIDS[algo][0] if lid_mode == "scalar"
            else np.asarray(LIDS[algo], dtype=np.int32)[slots % 2])
    if permits_kind is None:
        return slots, lids, None
    if permits_kind == "u8":
        return slots, lids, rng.integers(0, 45, shape).astype(np.uint8)
    permits = rng.integers(0, 45, shape).astype(np.int32)
    edge = rng.random(shape)
    permits[edge < 0.05] = 0
    permits[(edge >= 0.05) & (edge < 0.08)] = 300
    permits[(edge >= 0.08) & (edge < 0.09)] = INT32.max
    if algo == "sw":
        permits[(edge >= 0.09) & (edge < 0.12)] = -7
        permits[(edge >= 0.12) & (edge < 0.13)] = INT32.min
    return slots, lids, permits


@pytest.mark.parametrize("permits_kind", [None, "u8", "i32"])
@pytest.mark.parametrize("lid_mode", ["scalar", "lane"])
@pytest.mark.parametrize("algo", ["tb", "sw"])
def test_flat_step_matches_reference(algo, lid_mode, permits_kind):
    rng = np.random.default_rng(_seed(algo, lid_mode, permits_kind))
    ref, port = _engines()
    for i, now in enumerate(NOW):
        slots, lids, permits = _lanes(rng, algo, LANES, lid_mode,
                                      permits_kind)
        want = np.asarray(getattr(ref, f"{algo}_flat_dispatch")(
            slots, lids, permits, now))
        got = getattr(port, f"{algo}_flat_dispatch")(
            slots, lids, permits, now).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"step {i}")
        assert 0 < np.unpackbits(got).sum() < LANES
        _assert_state_equal(ref, port, algo, f"step {i}")


@pytest.mark.parametrize("permits_kind", [None, "i32"])
@pytest.mark.parametrize("lid_mode", ["scalar", "lane"])
@pytest.mark.parametrize("algo", ["tb", "sw"])
def test_scan_matches_reference(algo, lid_mode, permits_kind):
    """K sequential steps, each at its own ``now`` (rolling a window, then
    stepping back), over one state."""
    rng = np.random.default_rng(_seed("scan", algo, lid_mode, permits_kind))
    ref, port = _engines()
    k, b = 3, 128
    for call, base in enumerate((11_000, 12_400)):
        slots, lids, permits = _lanes(rng, algo, (k, b), lid_mode,
                                      permits_kind)
        now = np.array([base, base + 1_100, base + 300], dtype=np.int64)
        want = np.asarray(getattr(ref, f"{algo}_scan_dispatch")(
            slots, lids, permits, now))
        got = getattr(port, f"{algo}_scan_dispatch")(
            slots, lids, permits, now).numpy()
        assert got.shape == (k, b // 8)
        np.testing.assert_array_equal(got, want, err_msg=f"call {call}")
        _assert_state_equal(ref, port, algo, f"call {call}")


def test_flat_step_of_one_lane_and_ragged_bits():
    """A batch of 1 and of 13 lanes: the bits are padded to a whole byte
    with zeros, as np.packbits pads them."""
    for n in (1, 13):
        ref, port = _engines()
        slots = np.arange(n, dtype=np.int32)
        want = np.asarray(ref.tb_flat_dispatch(slots, 3, None, 11_000))
        got = port.tb_flat_dispatch(slots, 3, None, 11_000).numpy()
        np.testing.assert_array_equal(got, want)
        _assert_state_equal(ref, port, "tb", f"n={n}")


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 17, 64])
def test_packbits_matches_numpy(n):
    bits = np.random.default_rng(n).random(n) < 0.5
    np.testing.assert_array_equal(flat.packbits(torch.from_numpy(bits)),
                                  np.packbits(bits))


def test_multi_lid_assign_matches_reference():
    """``assign_batch_ints_multi`` through the port's binding gives the
    reference's slots and evictions on the same keys, with eviction churn
    and pinned slots, and shares the (lid, key) namespace of the one-lid
    assign."""
    require_reference_native()
    rng = np.random.default_rng(11)
    s = 256
    ref, port = ref_native.NativeSlotIndex(s), native_index.NativeSlotIndex(s)
    evicted = 0
    for step in range(6):
        keys = (rng.zipf(1.1, 200) - 1) % 600
        lids = rng.integers(1, 4, 200)
        pinned = set(rng.choice(s, 4).tolist()) if step % 2 else None
        want = ref.assign_batch_ints_multi(keys, lids, pinned=pinned,
                                           hold_pins=True)
        got = port.assign_batch_ints_multi(keys, lids, pinned=pinned,
                                           hold_pins=True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        evicted += len(want[1])
        ref.unpin_batch(want[0])
        port.unpin_batch(want[0])
    assert evicted > 0
    keys = np.array([5, 9], dtype=np.int64)
    one = port.assign_batch_ints(keys, 2)[0]
    multi = port.assign_batch_ints_multi(keys, np.array([2, 2]))[0]
    np.testing.assert_array_equal(multi, one)
    with pytest.raises(ValueError, match="limiter ids"):
        port.assign_batch_ints_multi(keys, np.array([2]))
