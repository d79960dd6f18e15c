"""One rule for a negative token-bucket permit (ROADMAP C11), on the CPU.

The solver kernel's contract is ``w >= 0`` and its plain version iterates
on negative weights as the reference's XLA solver does, so a negative
token-bucket permit would decide one way on the card and another on the
CPU.  Every storage surface that takes token-bucket permits refuses one
with ``ValueError`` before any state is touched, on a flat and a sharded
storage alike: the rows, the key->slot index and the limiter table stay
as they were.  Permit 0 and sliding-window negatives stay inside the
rule, and decide as the reference's storage decides them.
"""

import numpy as np
import pytest
import torch

from ratelimiter_tpu.core.config import RateLimitConfig as RefConfig
from ratelimiter_tpu.storage.tpu import TpuBatchedStorage
from ratelimiter_tpu_torch import RateLimitConfig
from ratelimiter_tpu_torch.engine.checkpoint import dump_slot_indexes
from ratelimiter_tpu_torch.engine.state import LimiterTable
from ratelimiter_tpu_torch.parallel import ShardedDeviceEngine
from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage
from torch_reference_native import (  # noqa: F401 (autouse fixture)
    idle_reference_flushers,
    require_reference_native,
)

torch.set_num_threads(1)

T0 = 1_700_000_000_000
TB = dict(max_permits=20, window_ms=1000, refill_rate=5.0)
SW = dict(max_permits=15, window_ms=1000)


def _storage(kind: str, clock):
    if kind == "sharded":
        eng = ShardedDeviceEngine(256, LimiterTable(device="cpu"),
                                  devices=["cpu"] * 2)
        return GpuBatchedStorage(engine=eng, clock_ms=lambda: clock["t"])
    return GpuBatchedStorage(num_slots=512, device="cpu", host_parallel=0,
                             clock_ms=lambda: clock["t"])


def _snapshot(st):
    eng = st.engine
    if hasattr(eng, "packed_host"):
        rows = {a: eng.packed_host(a) for a in ("sw", "tb")}
    else:
        rows = {"sw": eng.sw_packed.cpu().numpy().copy(),
                "tb": eng.tb_packed.cpu().numpy().copy()}
    index = dump_slot_indexes(st)
    return rows, index, st.table.generation


def _same_snapshot(a, b) -> None:
    for algo in ("sw", "tb"):
        np.testing.assert_array_equal(a[0][algo], b[0][algo], err_msg=algo)
    for algo, pa in a[1]["algos"].items():
        pb = b[1]["algos"][algo]
        assert pa.keys() == pb.keys()
        for name, va in pa.items():
            if isinstance(va, list) and va and isinstance(va[0], dict):
                for x, y in zip(va, pb[name]):
                    for k in x:
                        np.testing.assert_array_equal(x[k], y[k])
            else:
                np.testing.assert_array_equal(va, pb[name])
    assert a[2] == b[2]


def _block(keys):
    raw = [k.encode() for k in keys]
    offsets = np.zeros(len(raw) + 1, dtype=np.int64)
    offsets[1:] = np.cumsum([len(r) for r in raw])
    return np.frombuffer(b"".join(raw), dtype=np.uint8), offsets


def _tb_calls(st, lid):
    """Each token-bucket permit surface, called with one negative permit
    among positive ones."""
    keys = ["k1", "k2", "k3"]
    perms = np.array([1, -2, 3])
    data, offsets = _block(keys)
    return {
        "acquire": lambda: st.acquire("tb", lid, "k1", -1),
        "acquire_async": lambda: st.acquire_async("tb", lid, "k1", -4),
        "acquire_async_many": lambda: st.acquire_async_many(
            "tb", lid, keys, perms),
        "acquire_async_block": lambda: st.acquire_async_block(
            "tb", lid, data, offsets, perms),
        "acquire_many": lambda: st.acquire_many(
            "tb", [lid] * 3, keys, list(perms)),
        "acquire_many_ids": lambda: st.acquire_many_ids(
            "tb", lid, np.array([1, 2, 3]), perms),
        "acquire_stream_ids": lambda: st.acquire_stream_ids(
            "tb", lid, np.array([1, 2, 3]), perms),
        "acquire_stream_ids_lid_array": lambda: st.acquire_stream_ids(
            "tb", np.full(3, lid), np.array([1, 2, 3]), perms),
        "acquire_stream_strs": lambda: st.acquire_stream_strs(
            "tb", lid, keys, perms),
    }


SURFACES = sorted(_tb_calls(None, 0))


@pytest.mark.parametrize("kind", ["flat", "sharded"])
@pytest.mark.parametrize("surface", SURFACES)
def test_negative_tb_permit_raises_and_touches_nothing(kind, surface):
    clock = {"t": T0}
    st = _storage(kind, clock)
    try:
        lid = st.register_limiter("tb", RateLimitConfig(**TB))
        sw = st.register_limiter("sw", RateLimitConfig(**SW))
        # Some state first, so an untouched table is not an empty one.
        st.acquire_many_ids("tb", lid, np.arange(40), np.full(40, 2))
        st.acquire_stream_strs("sw", sw, [f"s{i}" for i in range(30)])
        clock["t"] += 17
        before = _snapshot(st)
        with pytest.raises(ValueError, match="negative token-bucket"):
            _tb_calls(st, lid)[surface]()
        st.flush()
        _same_snapshot(before, _snapshot(st))
    finally:
        st.close()


def _pair(clock):
    require_reference_native()
    ref = TpuBatchedStorage(num_slots=512, clock_ms=lambda: clock["t"],
                            host_parallel=0, observability=False)
    port = GpuBatchedStorage(num_slots=512, device="cpu", host_parallel=0,
                             clock_ms=lambda: clock["t"])
    lids = {}
    for algo, cfg in (("tb", TB), ("sw", SW)):
        a = ref.register_limiter(algo, RefConfig(**cfg))
        b = port.register_limiter(algo, RateLimitConfig(**cfg))
        assert a == b
        lids[algo] = a
    return ref, port, lids


def test_zero_tb_and_negative_sw_permits_decide_as_the_reference():
    """Permit 0 on token buckets and negative sliding-window permits pass
    the rule: streams, many-calls and single decisions equal the
    reference's, with the rows after each call."""
    clock = {"t": T0}
    ref, port, lids = _pair(clock)
    rng = np.random.default_rng(11)
    try:
        for step in range(6):
            clock["t"] += int(rng.choice([1, 250, 999, -40]))
            keys = rng.integers(0, 60, 300).astype(np.int64)
            tb_p = rng.integers(0, 6, 300)
            tb_p[::7] = 0
            sw_p = rng.integers(-3, 5, 300)
            for algo, perms in (("tb", tb_p), ("sw", sw_p)):
                got = port.acquire_stream_ids(algo, lids[algo], keys, perms)
                want = ref.acquire_stream_ids(algo, lids[algo], keys, perms)
                np.testing.assert_array_equal(got, want, err_msg=algo)
                got = port.acquire_many_ids(algo, lids[algo], keys[:64],
                                            perms[:64])
                want = ref.acquire_many_ids(algo, lids[algo], keys[:64],
                                            perms[:64])
                for name in ("allowed", "observed"):
                    np.testing.assert_array_equal(got[name], want[name],
                                                  err_msg=(algo, name))
            a = port.acquire("tb", lids["tb"], f"u{step}", 0)
            b = ref.acquire("tb", lids["tb"], f"u{step}", 0)
            assert (a["allowed"], int(a["remaining"])) == (
                b["allowed"], int(b["remaining"]))
            a = port.acquire("sw", lids["sw"], f"u{step}", -2)
            b = ref.acquire("sw", lids["sw"], f"u{step}", -2)
            assert (a["allowed"], int(a["observed"])) == (
                b["allowed"], int(b["observed"]))
        port.flush()
        ref.flush()
        for algo in ("sw", "tb"):
            np.testing.assert_array_equal(
                getattr(port.engine, f"{algo}_packed").cpu().numpy(),
                np.asarray(getattr(ref.engine, f"{algo}_packed")),
                err_msg=algo)
    finally:
        port.close()
        ref.close()
