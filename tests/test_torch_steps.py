"""The port's decision steps against the JAX package's, batch by batch.

Both engines start from the same state: the reference engine runs a few
warm-up batches and its packed state and policy table are carried into
the port with ``load_reference_state``.  Then the same staged batches
(duplicate keys, ``max_permits`` edges, window rollover, ``now`` moving
backward and below zero) go through ``micro_staged_dispatch`` on both,
and the fused outputs and the whole packed state must be byte-equal after
every batch.
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
from ratelimiter_tpu.ops import token_bucket as ref_tb
from ratelimiter_tpu_torch.engine.engine import DeviceEngine
from ratelimiter_tpu_torch.engine.state import (
    LimiterTable,
    load_reference_state,
)
from ratelimiter_tpu_torch.ops import sliding_window, token_bucket
from torch_reference_native import idle_reference_flushers  # noqa: F401

torch.set_num_threads(1)

NUM_SLOTS = 1024
BUCKET = 256
POLICIES = {  # lid -> (algo, config kwargs)
    1: ("sw", dict(max_permits=10, window_ms=1_000)),
    2: ("sw", dict(max_permits=100, window_ms=60_000)),
    3: ("tb", dict(max_permits=50, window_ms=60_000, refill_rate=10.0)),
    4: ("tb", dict(max_permits=5, window_ms=1_000, refill_rate=2.5)),
}
# Window rollover (1 s windows), a backward step, zero, below zero, and a
# jump past every window.
WARM_NOW = [10_000, 10_400, 10_999]
NOW = [11_000, 11_600, 10_700, 12_050, 12_999, 0, -250, 75_000, 75_001]


def _engines():
    ref_table = RefTable()
    for lid in sorted(POLICIES):
        assert ref_table.register(RefConfig(**POLICIES[lid][1])) == lid
    ref = RefEngine(NUM_SLOTS, ref_table)
    port = DeviceEngine(NUM_SLOTS, LimiterTable(device="cpu"), device="cpu")
    _carry(ref, ref_table, port)
    return ref, ref_table, port


def _carry(ref, ref_table, port):
    load_reference_state(
        port, np.asarray(ref.sw_packed), np.asarray(ref.tb_packed),
        [ref_table.host_policy(l) for l in range(len(ref_table))])


def _staged(rng, algo, now, n):
    """One staged i64[4, BUCKET] batch: n live lanes over 48 hot slots
    (Zipf duplicates), limiter ids of the algo, permits around max."""
    lids = [l for l, (a, _) in POLICIES.items() if a == algo]
    staged = np.empty((4, BUCKET), dtype=np.int64)
    staged[0], staged[1], staged[2] = -1, 0, 1
    staged[0, :n] = (rng.zipf(1.2, n) - 1) % 48 * 7
    staged[1, :n] = rng.choice(lids, n)
    maxp = np.array([POLICIES[l][1]["max_permits"] for l in staged[1, :n]])
    edges = np.stack([np.ones(n, np.int64), maxp - 1, maxp, maxp + 1], 1)
    staged[2, :n] = np.where(rng.random(n) < 0.3,
                             edges[np.arange(n), rng.integers(0, 4, n)],
                             rng.integers(1, maxp + 1))
    staged[3, 0] = now
    return staged


def _run(ref, port, algo, staged, n):
    ref_out = np.asarray(ref.micro_staged_dispatch(algo, staged.copy(), n))
    port_out = port.micro_staged_dispatch(algo, staged.copy(), n)
    return ref_out, port_out.numpy()


@pytest.mark.parametrize("algo", ["sw", "tb"])
def test_staged_steps_byte_equal_after_every_batch(algo):
    rng = np.random.default_rng(0 if algo == "sw" else 1)
    ref, ref_table, port = _engines()
    for now in WARM_NOW:
        n = int(rng.integers(150, BUCKET))
        ref.micro_staged_drain(algo, ref.micro_staged_dispatch(
            algo, _staged(rng, algo, now, n), n), n)
    _carry(ref, ref_table, port)
    packed = "sw_packed" if algo == "sw" else "tb_packed"
    assert np.asarray(getattr(ref, packed)).any()
    for now in NOW:
        n = int(rng.integers(129, BUCKET + 1))  # stays in the 256 bucket
        ref_out, port_out = _run(ref, port, algo, _staged(rng, algo, now, n),
                                 n)
        assert port_out.dtype == np.int64
        np.testing.assert_array_equal(port_out, ref_out)
        np.testing.assert_array_equal(getattr(port, packed).numpy(),
                                      np.asarray(getattr(ref, packed)))
        # Decoded decisions agree too (same drain contract).
        want = ref.micro_staged_drain(algo, ref_out, n)
        got = port.micro_staged_drain(algo, torch.from_numpy(port_out), n)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("algo", ["sw", "tb"])
def test_uniform_tenant_step_and_codec(algo):
    """A 0-d limiter id (one tenant, policy row read once) through the
    packed step directly; the rows the step writes are the reference's
    bytes."""
    rng = np.random.default_rng(7)
    ref, ref_table, port = _engines()
    lid = 2 if algo == "sw" else 3
    ref_step = ref_sw.sw_step_p if algo == "sw" else ref_tb.tb_step_p
    port_step = (sliding_window.sw_step_p if algo == "sw"
                 else token_bucket.tb_step_p)
    packed_name = "sw_packed" if algo == "sw" else "tb_packed"
    ref_packed = getattr(ref, packed_name)
    step = jax.jit(ref_step)
    for now in (5_000, 65_000, 64_000):
        slots = rng.integers(-1, 30, 64)
        permits = rng.integers(1, 60, 64)
        ref_packed, ref_out = step(
            ref_packed, ref_table.device_arrays,
            jnp.asarray(slots, jnp.int32), jnp.asarray(lid, jnp.int32),
            jnp.asarray(permits), jnp.asarray(now, jnp.int64))
        port_out = port_step(
            getattr(port, packed_name), port.table.device_arrays,
            torch.from_numpy(slots), torch.tensor(lid),
            torch.from_numpy(permits), now)
        for got, want in zip(port_out, ref_out):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(getattr(port, packed_name).numpy(),
                                      np.asarray(ref_packed))


def test_peek_clear_and_row_access_match_reference():
    rng = np.random.default_rng(3)
    ref, ref_table, port = _engines()
    for algo in ("sw", "tb"):
        for now in WARM_NOW:
            staged = _staged(rng, algo, now, 200)
            _run(ref, port, algo, staged, 200)
    slots = list(range(0, 48 * 7, 7))
    for algo, lid in (("sw", 1), ("tb", 4)):
        for now in (10_999, 11_500, 40_000):
            peek = "sw_available" if algo == "sw" else "tb_available"
            np.testing.assert_array_equal(
                getattr(port, peek)(slots, [lid] * len(slots), now),
                getattr(ref, peek)(slots, [lid] * len(slots), now))
        np.testing.assert_array_equal(port.read_rows(algo, slots),
                                      ref.read_rows(algo, slots))
        clear = "sw_clear" if algo == "sw" else "tb_clear"
        getattr(port, clear)(slots[::3] + [-1])
        getattr(ref, clear)(slots[::3] + [-1])
        rows = rng.integers(-(1 << 30), 1 << 30,
                            (5, 6 if algo == "sw" else 4)).astype(np.int32)
        port.write_rows(algo, slots[1:6], rows)
        ref.write_rows(algo, slots[1:6], rows)
        packed = "sw_packed" if algo == "sw" else "tb_packed"
        np.testing.assert_array_equal(getattr(port, packed).numpy(),
                                      np.asarray(getattr(ref, packed)))
