"""The port's kernel modules against the JAX package, on the CPU.

The CUDA kernels cannot run here; their plain PyTorch versions (what a CPU
tensor takes) are held exactly equal to the reference package: the XLA
solver and the Pallas solver (interpret mode) for the segmented solver,
the Pallas block scatter (interpret mode) and the XLA drop scatter for the
row scatter.  Every quantity is an integer, so equality is exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ratelimiter_tpu.core.config import TOKEN_FP_ONE, TOKEN_FP_SHIFT
from ratelimiter_tpu.ops import scatter as ref_scatter
from ratelimiter_tpu.ops import segments as ref_segments
from ratelimiter_tpu.ops.pallas import block_scatter as ref_block_scatter
from ratelimiter_tpu.ops.pallas import solver as ref_solver
from ratelimiter_tpu_torch.ops import scatter, segments, sorting
from ratelimiter_tpu_torch.ops.cuda import block_scatter, build, solver
from torch_reference_native import idle_reference_flushers  # noqa: F401

torch.set_num_threads(1)


def _sorted_slots(rng, n, n_keys, pad=0, zipf=False):
    live = (rng.zipf(1.1, n - pad) % n_keys if zipf
            else rng.integers(0, n_keys, n - pad))
    return np.sort(np.concatenate([np.full(pad, -1), live])).astype(np.int64)


SOLVER_KINDS = ["duplicates", "hot_segment", "padding", "token_bucket",
                "runs_31_32_33", "runs_1023_1024_1025", "dead_in_live",
                "weightless", "all_dead", "one_lane", "lanes_8191",
                "lanes_32771"]
#: Above this many lanes the Pallas solver (interpret mode) is too slow to
#: run on the CPU; those cases are held to the XLA solver and the walk.
PALLAS_MAX_LANES = 256


def _solver_case(kind, rng, n=256):
    """(sorted slots, u, w) for one solver case."""
    if kind == "duplicates":
        slots = _sorted_slots(rng, n, 40)
        return slots, rng.integers(-5, 40, n), rng.integers(1, 9, n)
    if kind == "hot_segment":
        return np.zeros(n, np.int64), np.full(n, 100), np.ones(n, np.int64)
    if kind == "padding":
        # A bucket just under half full: the padding run sorts first.
        slots = _sorted_slots(rng, n, 16, pad=n // 2 + 1, zipf=True)
        u = np.where(slots >= 0, rng.integers(0, 30, n), -1)
        return slots, u, np.ones(n, np.int64)
    if kind.startswith("runs_"):
        # Segments of exactly these lengths, each crossing a 32-lane word
        # or a 1024-lane boundary at its edge.
        lengths = [int(x) for x in kind.split("_")[1:]]
        slots = np.repeat(np.arange(len(lengths)), lengths).astype(np.int64)
        n = len(slots)
        return slots, rng.integers(-3, n // 2, n), rng.integers(0, 3, n)
    if kind == "dead_in_live":
        # Pre-rejected lanes (u < 0) inside live segments.
        slots = _sorted_slots(rng, n, 6, zipf=True)
        u = np.where(rng.random(n) < 0.3, -1, rng.integers(0, 60, n))
        return slots, u, rng.integers(1, 5, n)
    if kind == "weightless":
        slots = _sorted_slots(rng, n, 8, zipf=True)
        w = np.where(rng.random(n) < 0.3, 0, rng.integers(1, 6, n))
        return slots, rng.integers(-2, 50, n), w
    if kind == "all_dead":
        slots = _sorted_slots(rng, n, 10, pad=n // 4)
        return slots, np.full(n, -1), rng.integers(0, 4, n)
    if kind == "one_lane":
        return np.array([3], np.int64), np.array([0]), np.array([7])
    if kind.startswith("lanes_"):
        # Beyond one 8192-lane bucket: many short segments, a hot key of
        # hundreds of lanes and a padding run.
        n = int(kind.split("_")[1])
        slots = _sorted_slots(rng, n, n // 3, pad=n // 5, zipf=True)
        u = np.where(slots >= 0, rng.integers(-10, 300, n), -1)
        return slots, u, np.ones(n, np.int64)
    # Token bucket: w = permits * TOKEN_FP_ONE, u = refilled - request.
    slots = _sorted_slots(rng, n, 24, pad=5, zipf=True)
    permits = rng.integers(1, 60, n)
    req = permits * TOKEN_FP_ONE
    v1 = rng.integers(0, 50 * TOKEN_FP_ONE, n)
    u = np.where((slots >= 0) & (permits <= 50), v1 - req, -1)
    return slots, u, req


def _sequential_walk(u, w, first):
    """The solver's definition, lane by lane: S restarts at each segment
    head (lane 0 always is one); inc[j] = (S <= u[j]); S += w[j] * inc[j]."""
    inc = np.zeros(len(u), np.int64)
    s = 0
    for j in range(len(u)):
        if j == 0 or first[j]:
            s = 0
        if s <= u[j]:
            inc[j] = 1
            s += w[j]
    return inc


@pytest.mark.parametrize("kind", SOLVER_KINDS)
def test_plain_solver_matches_reference_solvers(kind):
    rng = np.random.default_rng(SOLVER_KINDS.index(kind))
    slots, u, w = _solver_case(kind, rng)
    u, w = np.asarray(u, np.int64), np.asarray(w, np.int64)
    first_j = ref_segments.first_occurrence(jnp.asarray(slots))
    xla = np.asarray(ref_segments.solve_threshold_recurrence(
        jnp.asarray(u), jnp.asarray(w), first_j))

    first = segments.first_occurrence(torch.from_numpy(slots))
    np.testing.assert_array_equal(first.numpy(), np.asarray(first_j))
    port = solver.solve_threshold_recurrence_auto(
        torch.from_numpy(u), torch.from_numpy(w), first)
    assert port.dtype == torch.int64
    np.testing.assert_array_equal(port.numpy(), xla)
    np.testing.assert_array_equal(port.numpy(),
                                  _sequential_walk(u, w, first.numpy()))
    if len(u) <= PALLAS_MAX_LANES:
        # The Pallas kernel's i32 domain, exactly as
        # solve_threshold_recurrence_auto prepares it.
        shift = TOKEN_FP_SHIFT if kind == "token_bucket" else 0
        u32 = np.clip(u >> shift, -1, ref_solver.SAT - 1).astype(np.int32)
        w32 = np.clip(w >> shift, 0, ref_solver.SAT).astype(np.int32)
        pallas = np.asarray(ref_solver.pallas_solve(
            jnp.asarray(u32), jnp.asarray(w32),
            ref_solver.seg_first_index(first_j), interpret=True))
        np.testing.assert_array_equal(port.numpy(), pallas)


def test_segment_primitives_match_reference():
    rng = np.random.default_rng(5)
    slots = _sorted_slots(rng, 200, 30, pad=9, zipf=True)
    x = rng.integers(0, 1000, 200)
    first_j = ref_segments.first_occurrence(jnp.asarray(slots))
    first = segments.first_occurrence(torch.from_numpy(slots))
    pairs = [
        (segments.last_occurrence(torch.from_numpy(slots)),
         ref_segments.last_occurrence(jnp.asarray(slots))),
        (segments.segmented_cumsum_exclusive(torch.from_numpy(x), first),
         ref_segments.segmented_cumsum_exclusive(jnp.asarray(x), first_j)),
        (segments.segment_totals(torch.from_numpy(x), first),
         ref_segments.segment_totals(jnp.asarray(x), first_j)),
    ]
    for got, want in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sort_batch_is_the_reference_permutation():
    rng = np.random.default_rng(6)
    slots = rng.integers(-1, 20, 300)
    order_j = np.asarray(jnp.argsort(jnp.asarray(slots), stable=True))
    inv, s, (pos,) = sorting.sort_batch(torch.from_numpy(slots),
                                        torch.arange(300))
    np.testing.assert_array_equal(pos.numpy(), order_j)
    np.testing.assert_array_equal(s.numpy(), slots[order_j])
    np.testing.assert_array_equal(sorting.unsort(s, inv).numpy(), slots)


def _scatter_case(rng, S, B, lanes, pad):
    state = rng.integers(-(1 << 30), 1 << 30, (S, lanes)).astype(np.int32)
    slots = np.sort(rng.choice(S, size=B - pad, replace=True))
    slots = np.concatenate([np.full(pad, -1), slots]).astype(np.int32)
    mask = (slots >= 0) & np.r_[slots[:-1] != slots[1:], True]
    rows = rng.integers(-(1 << 30), 1 << 30, (B, lanes)).astype(np.int32)
    return state, slots, mask, rows


def _port_scatter(state, slots, mask, rows):
    out = torch.from_numpy(state.copy())
    res = scatter.scatter_rows(
        out, torch.from_numpy(slots.astype(np.int64)),
        torch.from_numpy(mask), torch.from_numpy(rows))
    assert res is out  # in place
    return out.numpy()


@pytest.mark.parametrize("lanes", [4, 6])
def test_plain_scatter_matches_pallas_block_scatter(lanes):
    rng = np.random.default_rng(lanes)
    state, slots, mask, rows = _scatter_case(rng, 512, 512, lanes, pad=7)
    want = np.asarray(ref_block_scatter.scatter_rows(
        jnp.asarray(state), jnp.asarray(slots), jnp.asarray(mask),
        jnp.asarray(rows), interpret=True))
    np.testing.assert_array_equal(_port_scatter(state, slots, mask, rows),
                                  want)


@pytest.mark.parametrize("lanes", [4, 6])
def test_plain_scatter_matches_xla_drop_scatter(lanes):
    rng = np.random.default_rng(10 + lanes)
    # 1000 rows: not a multiple of the TPU kernel's 256-row block.
    state, slots, mask, rows = _scatter_case(rng, 1000, 32, lanes, pad=3)
    want = np.asarray(ref_scatter.scatter_rows_sorted(
        jnp.asarray(state), jnp.asarray(slots), jnp.asarray(mask),
        jnp.asarray(rows)))
    np.testing.assert_array_equal(_port_scatter(state, slots, mask, rows),
                                  want)


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers take CUDA tensors only: a CPU tensor reaching
    them raises before any build or launch."""
    u = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        solver.solve_cuda(u, u, torch.ones(8, dtype=torch.bool))
    with pytest.raises(ValueError, match="CUDA"):
        block_scatter.scatter_rows(
            torch.zeros((4, 6), dtype=torch.int32), u,
            torch.ones(8, dtype=torch.bool),
            torch.zeros((8, 6), dtype=torch.int32))
    now = torch.tensor(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        block_scatter.tb_writeback(torch.zeros((4, 4), dtype=torch.int32),
                                   u, u, u, u, u, u, now)
    with pytest.raises(ValueError, match="CUDA"):
        block_scatter.sw_writeback(torch.zeros((4, 6), dtype=torch.int32),
                                   u, u, u, u, u, u, u, u, u, now)
    assert solver.launches == 0 and block_scatter.launches == 0
    assert block_scatter.tb_writeback_launches == 0
    assert block_scatter.sw_writeback_launches == 0


def test_kernel_build_targets_hopper_and_rebuilds_on_edit(tmp_path,
                                                         monkeypatch):
    monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
    cmd = build.nvcc_command("solver", tmp_path / "lib.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[-1].endswith("solver.cu")
    assert build.BUILD_DIR.parts[-2:] == ("build", "kernels")
    (tmp_path / "solver.cu").write_text("// one\n")
    monkeypatch.setattr(build, "SRC_DIR", tmp_path)
    before = build.library_path("solver")
    (tmp_path / "solver.cu").write_text("// two\n")
    assert build.library_path("solver") != before
