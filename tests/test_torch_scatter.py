"""The port's row scatter against the JAX package's, on the CPU.

``ops/scatter.py:scatter_rows`` on a CPU tensor takes its plain version,
``scatter_rows_plain``; the CUDA kernel (``ops/cuda/block_scatter.cu:
rl_scatter_rows``) cannot run here.  The plain version is held exactly
equal to the reference's two row writes: XLA's drop-mode scatter as the
relay writes it (``ratelimiter_tpu/ops/relay.py:_scatter_rows``, lanes in
arrival order) and the Pallas block scatter in interpret mode (lanes
sorted by slot).  Every quantity is an integer, so equality is exact.  The
kernel's wrapper must refuse what the kernel cannot take before it builds
or launches anything.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ratelimiter_tpu.ops.pallas import block_scatter as ref_block_scatter
from ratelimiter_tpu_torch.ops import scatter
from ratelimiter_tpu_torch.ops.cuda import block_scatter, build
from torch_reference_native import idle_reference_flushers  # noqa: F401

torch.set_num_threads(1)

LANES = [1, 3, 4, 5, 6, 8]


def _rows(rng, n, lanes):
    return rng.integers(-(1 << 30), 1 << 30, (n, lanes)).astype(np.int32)


def _arrival_lanes(rng, S, n, lanes):
    """(slots, mask, rows) in arrival order, as the relay's row writes take
    them: live lanes on slots in [0, S) or past the table (>= S, which both
    drop), each live slot once; masked-out lanes on padding (-1), on
    slots past the table, and on repeats of live slots with other rows."""
    live = rng.choice(S + 8, size=n, replace=False)
    mask = rng.random(n) < 0.7
    slots = live.copy()
    dead = np.flatnonzero(~mask)
    kind = rng.integers(0, 3, len(dead))
    slots[dead[kind == 0]] = -1
    slots[dead[kind == 1]] = S + rng.integers(0, 100, (kind == 1).sum())
    repeat = dead[kind == 2]
    if mask.any() and len(repeat):
        slots[repeat] = rng.choice(live[mask], len(repeat))
    return slots.astype(np.int64), mask, _rows(rng, n, lanes)


def _port(state, slots, mask, rows):
    out = torch.from_numpy(state.copy())
    res = scatter.scatter_rows(out, torch.from_numpy(slots),
                               torch.from_numpy(mask), torch.from_numpy(rows))
    assert res is out  # in place
    return out.numpy()


@pytest.mark.parametrize("n", [1, 7, 300, 1025])
@pytest.mark.parametrize("lanes", LANES)
def test_plain_scatter_matches_xla_drop_scatter(lanes, n):
    """Arrival-order lanes, ragged lengths: the reference's unsorted relay
    write, ``state.at[where(mask, slot, S)].set(rows, mode="drop")``."""
    rng = np.random.default_rng(100 * lanes + n)
    S = 1500  # not a multiple of the TPU kernel's 256-row block
    state = _rows(rng, S, lanes)
    slots, mask, rows = _arrival_lanes(rng, S, n, lanes)
    widx = jnp.where(jnp.asarray(mask), jnp.asarray(slots), jnp.int64(S))
    want = np.asarray(jnp.asarray(state).at[widx].set(jnp.asarray(rows),
                                                      mode="drop"))
    np.testing.assert_array_equal(_port(state, slots, mask, rows), want)


@pytest.mark.parametrize("lanes", LANES)
def test_plain_scatter_matches_pallas_block_scatter(lanes):
    """Slot-sorted lanes (padding first, each slot's last lane live): the
    reference's Pallas block scatter in interpret mode."""
    rng = np.random.default_rng(lanes)
    S, B, pad = 512, 512, 9
    state = _rows(rng, S, lanes)
    slots = np.sort(np.concatenate(
        [np.full(pad, -1), rng.choice(S, size=B - pad, replace=True)]))
    mask = (slots >= 0) & np.r_[slots[:-1] != slots[1:], True]
    rows = _rows(rng, B, lanes)
    want = np.asarray(ref_block_scatter.scatter_rows(
        jnp.asarray(state), jnp.asarray(slots.astype(np.int32)),
        jnp.asarray(mask), jnp.asarray(rows), interpret=True))
    np.testing.assert_array_equal(_port(state, slots, mask, rows), want)


def test_plain_scatter_drops_live_lanes_off_the_table():
    """The port's contract beyond the reference's callers: a lane whose
    mask is set but whose slot is negative or past the table is dropped
    (the reference's live lanes never carry one), and live duplicates
    that carry identical rows write that row."""
    rng = np.random.default_rng(7)
    S, lanes = 64, 6
    state = _rows(rng, S, lanes)
    slots = np.array([-1, -7, S, S + 5, 1 << 40, 3, 3, 9], dtype=np.int64)
    mask = np.ones(len(slots), dtype=bool)
    rows = _rows(rng, len(slots), lanes)
    rows[6] = rows[5]
    want = state.copy()
    want[3], want[9] = rows[5], rows[7]
    np.testing.assert_array_equal(_port(state, slots, mask, rows), want)


def _refusals():
    i32 = torch.int32
    state = torch.zeros((16, 6), dtype=i32)
    slots = torch.zeros(8, dtype=torch.int64)
    mask = torch.ones(8, dtype=torch.bool)
    rows = torch.zeros((8, 6), dtype=i32)
    return {
        # CPU tensors: the first argument that is not on the card.
        "cpu-state": ((state, slots, mask, rows), "CUDA"),
        # Shapes and types, with the device check passed.
        "rows-lanes": ((state, slots, mask, torch.zeros((8, 4), dtype=i32)),
                       "shapes do not agree"),
        "slots-length": ((state, slots[:7], mask, rows),
                         "shapes do not agree"),
        "mask-length": ((state, slots, mask[:7], rows),
                        "shapes do not agree"),
        "slots-dtype": ((state, slots.to(i32), mask, rows), "int64"),
        "mask-dtype": ((state, slots, mask.to(torch.uint8), rows), "bool"),
        "state-rank": ((state.reshape(-1), slots, mask, rows), "rank 2"),
        "rows-strided": ((state, slots, mask,
                          torch.zeros((8, 12), dtype=i32)[:, ::2]),
                         "contiguous"),
    }


@pytest.mark.parametrize("case", list(_refusals()))
def test_cuda_scatter_wrapper_refuses_before_build_or_launch(case,
                                                            monkeypatch):
    """The CUDA wrapper takes contiguous CUDA tensors of the kernel's types
    and agreeing shapes only: anything else raises before a build or a
    launch (``build.load`` is never reached, ``launches`` stays 0).  Past
    the first case the device check is stood in for, so that the shape and
    type checks behind it are reached on the CPU."""
    args, match = _refusals()[case]

    def no_build(name):
        raise AssertionError(f"built {name}")

    monkeypatch.setattr(build, "load", no_build)
    monkeypatch.setattr(block_scatter, "launches", 0)
    if case != "cpu-state":
        real = build.require
        monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))

        def require(t, name, dtype, ndim, device=None):
            real(t, name, dtype, ndim)

        monkeypatch.setattr(build, "require", require)
    with pytest.raises(ValueError, match=match):
        block_scatter.scatter_rows(*args)
    assert block_scatter.launches == 0
