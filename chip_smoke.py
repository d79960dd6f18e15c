#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``ratelimiter_tpu_torch``) on one
NVIDIA H100.

Run from the repository root, on a machine with the card and the CUDA
toolkit:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. Card: name and power limit (nvidia-smi), torch and CUDA versions, and
   the build of both kernels from ``ratelimiter_tpu_torch/ops/cuda/*.cu``
   (one nvcc per source, started together).
2. Kernels against their plain PyTorch versions on the card, at the main
   path's shapes; results must be bit-equal.  Each kernel's median time
   (CUDA events), its plain version's time and, for the scatter, the time
   of ``index_put_`` on the same live rows (a yardstick the port never
   calls).
3. Main path: ``GpuBatchedStorage(num_slots=1 << 20)`` on the card with
   the service's api / auth / burst limiters on a deterministic clock;
   a few thousand ``try_acquire`` calls (Zipf(1.1) keys over 1M, token
   bucket permits in [1, 100], the clock crossing window boundaries and
   stepping backward once) and 8192-lane ``try_acquire_many`` bursts.
   Every decision is checked against ``semantics/oracle.py``; both
   kernels' launch counters must have grown during this phase.
4. Where a micro step's time goes: host enqueue, device time and drain of
   one staged step at 32 and 8192 lanes.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20251016
NUM_SLOTS = 1 << 20
KEY_SPACE = 1 << 20
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
ALU_OPS_PER_S = 67e12            # H100 SXM non-tensor fp32 peak, as the
                                 # stand-in for the integer ALU rate
# One step of the solver's dependent chain, in SM cycles: an int64 compare
# (two dependent 32-bit compares) and an int64 add (two dependent 32-bit
# adds, the carry first) issue side by side, then S is selected: three
# dependent integer instructions at about 4 cycles each.
WALK_STEP_CYCLES = 12
TRIO = {
    # name: (algo, RateLimitConfig kwargs) — service/wiring.py's trio.
    "api": ("sw", dict(max_permits=100, window_ms=60_000,
                       enable_local_cache=True, local_cache_ttl_ms=100)),
    "auth": ("sw", dict(max_permits=10, window_ms=60_000,
                        enable_local_cache=False)),
    "burst": ("tb", dict(max_permits=50, window_ms=60_000,
                         refill_rate=10.0)),
}
N_SINGLE = 3000
N_BURSTS = 6
BURST = 8192


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip smoke check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0].strip()


def cuda_ms(fn, reps: int, rounds: int = 5):
    """Time per call of ``fn`` on the card: ``(device_ms, host_ms)``.

    ``host_ms`` is the host's time per call, enqueue included.
    ``device_ms`` is the median over ``rounds`` of CUDA events around
    ``reps`` back-to-back calls, divided by ``reps``; each round first
    enqueues a sleep kernel that outlasts the host's enqueue of the calls,
    so the card runs them back to back and the events time the card, not
    the host's launch rate."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    # Cycles at 2 GHz (above the H100's boost clock), with 50% headroom.
    sleep_cycles = int(host_s * 1.5 * 2e9) + 100_000
    times = []
    for _ in range(rounds):
        torch.cuda._sleep(sleep_cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times), host_s / reps * 1e3


def zipf_keys(rng, n: int) -> np.ndarray:
    return (rng.zipf(1.1, n) - 1) % KEY_SPACE


def sm_clock_hz() -> float:
    """The card's highest SM clock, from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def walk_ms(steps: int, clock_hz: float) -> float:
    """Least time of a chain of ``steps`` dependent solver steps."""
    return steps * WALK_STEP_CYCLES / clock_hz * 1e3


def bound_ms(nbytes: float, ops: float, walk: float = 0.0):
    """The larger of the bytes term and the operations term; ``walk`` is
    the time of the longest dependent chain of operations, which bounds
    the operations term from below whatever the ALU rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / ALU_OPS_PER_S * 1e3, walk)
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


# -- phase 2: kernels against their plain versions -------------------------
def solver_cases(rng):
    """(name, sorted slots) at the solver's main-path shapes."""
    cases = []
    for n in (32, 512, 8192):
        cases.append((f"zipf-{n}", np.sort(zipf_keys(rng, n))))
    cases.append(("one-key-8192", np.full(8192, 12345)))
    live = 4097  # the 8192 bucket's longest padding run: 4095 lanes
    cases.append(("live-4097-of-8192", np.sort(np.concatenate(
        [np.full(8192 - live, -1), zipf_keys(rng, live)]))))
    return cases


def solver_inputs(rng, slots: np.ndarray, algo: str, dev):
    """u, w as the sliding-window and token-bucket steps build them."""
    from ratelimiter_tpu_torch.core.config import TOKEN_FP_ONE

    n = len(slots)
    valid = slots >= 0
    if algo == "tb":
        permits = rng.integers(1, 101, n)
        req = permits * TOKEN_FP_ONE
        v1 = rng.integers(0, 50 * TOKEN_FP_ONE + 1, n)
        u = np.where(valid & (permits <= 50), v1 - req, -1)
        w = req
    else:
        permits = rng.integers(1, 4, n)
        u = np.where(valid, 100 - rng.integers(0, 60, n) - permits, -1)
        w = np.ones(n, np.int64)
    return (torch.as_tensor(u, dtype=torch.int64, device=dev),
            torch.as_tensor(w, dtype=torch.int64, device=dev))


def phase_kernels(rng, dev):
    from ratelimiter_tpu_torch.ops import scatter, segments
    from ratelimiter_tpu_torch.ops.cuda import block_scatter, solver

    results = {"solver": {"err": 0}, "block_scatter": {"err": 0}}
    clock_hz = sm_clock_hz()
    print(f"SM clock (max) {clock_hz / 1e6:.0f} MHz; solver walk step "
          f"{WALK_STEP_CYCLES} cycles")
    for name, slots_np in solver_cases(rng):
        slots = torch.as_tensor(slots_np, dtype=torch.int64, device=dev)
        first = segments.first_occurrence(slots)
        longest = int(np.max(np.diff(np.flatnonzero(np.r_[
            True, slots_np[1:] != slots_np[:-1], True]))))
        for algo in ("sw", "tb"):
            u, w = solver_inputs(rng, slots_np, algo, dev)
            got = solver.solve_cuda(u, w, first)
            want = segments.solve_threshold_recurrence(u, w, first)
            torch.cuda.synchronize()
            err = int((got - want).abs().max())
            results["solver"]["err"] = max(results["solver"]["err"], err)
            check(err == 0, f"solver {name} {algo}: kernel != plain")
            k_ms, k_host = cuda_ms(lambda: solver.solve_cuda(u, w, first),
                                   reps=50)
            p_ms, _ = cuda_ms(
                lambda: segments.solve_threshold_recurrence(u, w, first),
                reps=2, rounds=3)
            n = len(slots_np)
            w_ms = walk_ms(longest, clock_hz)
            b_ms, b_by = bound_ms(25 * n, 2 * n, w_ms)
            print(f"solver {name:18s} {algo}: lanes {n} longest segment "
                  f"{longest}  kernel {k_ms:.5f} ms (host {k_host:.5f} ms "
                  f"per call)  plain {p_ms:.5f} ms  "
                  f"bound {b_ms:.7f} ms ({b_by}; walk {w_ms:.7f} ms, "
                  f"bytes {25 * n / HBM_BYTES_PER_S * 1e3:.7f} ms)  "
                  f"kernel/bound {k_ms / b_ms:.1f}  max_abs_err {err}")
            if name == "zipf-8192" and algo == "tb":
                results["solver"].update(ms=k_ms, plain_ms=p_ms,
                                         bound_ms=b_ms, bound_by=b_by,
                                         library_ms=None)

    for lanes in (4, 6):
        state0 = torch.randint(-(1 << 30), 1 << 30, (NUM_SLOTS, lanes),
                               dtype=torch.int32, device=dev)
        for n in (32, 8192):
            pad = n // 16
            slots_np = np.sort(np.concatenate(
                [np.full(pad, -1), zipf_keys(rng, n - pad)]))
            mask_np = (slots_np >= 0) & np.r_[slots_np[1:] != slots_np[:-1],
                                              True]
            slots = torch.as_tensor(slots_np, dtype=torch.int64, device=dev)
            mask = torch.as_tensor(mask_np, device=dev)
            rows = torch.randint(-(1 << 30), 1 << 30, (n, lanes),
                                 dtype=torch.int32, device=dev)
            got = block_scatter.scatter_rows(state0.clone(), slots, mask,
                                             rows)
            want = scatter.scatter_rows_plain(state0.clone(), slots, mask,
                                              rows)
            torch.cuda.synchronize()
            err = int((got.to(torch.int64) - want.to(torch.int64))
                      .abs().max())
            results["block_scatter"]["err"] = max(
                results["block_scatter"]["err"], err)
            check(err == 0, f"scatter L={lanes} B={n}: kernel != plain")
            state = state0.clone()
            live = int(mask_np.sum())
            live_slots, live_rows = slots[mask], rows[mask].contiguous()
            k_ms, k_host = cuda_ms(lambda: block_scatter.scatter_rows(
                state, slots, mask, rows), reps=100)
            p_ms, _ = cuda_ms(lambda: scatter.scatter_rows_plain(
                state, slots, mask, rows), reps=20)
            l_ms, _ = cuda_ms(
                lambda: state.index_put_((live_slots,), live_rows), reps=100)
            # Every lane's slot and mask read; each live lane's row read
            # and written.
            b_ms, b_by = bound_ms(n * (8 + 1) + live * 8 * lanes, 0)
            print(f"scatter S={NUM_SLOTS} L={lanes} B={n:5d} live {live:5d}: "
                  f"kernel {k_ms:.5f} ms (host {k_host:.5f} ms per call)  "
                  f"plain {p_ms:.5f} ms  index_put_ {l_ms:.5f} ms  "
                  f"bound {b_ms:.7f} ms ({b_by})  max_abs_err {err}")
            if lanes == 6 and n == 8192:
                results["block_scatter"].update(ms=k_ms, plain_ms=p_ms,
                                                bound_ms=b_ms, bound_by=b_by,
                                                library_ms=l_ms)
    return results


# -- phase 3: the main path ---------------------------------------------------
class Reference:
    """What one limiter must decide: the oracle, plus the sliding
    window's local negative cache where the limiter has one.

    ``stamp(now)`` gives the storage's batch timestamp — the running
    maximum of the clock over the calls that reach the storage — and is
    taken only by such calls (a cache hit or a client-side reject never
    dispatches)."""

    def __init__(self, algo, cfg, clock, stamp):
        from ratelimiter_tpu_torch.cache import TTLCache
        from ratelimiter_tpu_torch.semantics import (
            SlidingWindowOracle,
            TokenBucketOracle,
        )

        self.algo, self.cfg, self.clock, self.stamp = algo, cfg, clock, stamp
        self.oracle = (SlidingWindowOracle(cfg) if algo == "sw"
                       else TokenBucketOracle(cfg))
        self.cache = (TTLCache(cfg.local_cache_ttl_ms, 10_000, clock)
                      if algo == "sw" and cfg.enable_local_cache else None)

    def one(self, key, permits) -> bool:
        if self.cache is not None:
            cached = self.cache.get_if_present(key)
            if cached is not None and cached >= self.cfg.max_permits:
                return False
        if self.algo == "tb" and permits > self.cfg.max_permits:
            return False
        d = self.oracle.try_acquire(key, permits, self.stamp(self.clock()))
        if self.cache is not None:
            self.cache.put(key, d.remaining_hint if d.mutated
                           else d.observed)
        return d.allowed

    def many(self, keys, permits) -> np.ndarray:
        now = self.stamp(self.clock())
        out = [self.oracle.try_acquire(k, int(p), now)
               for k, p in zip(keys, permits)]
        if self.cache is not None:
            for k, d in zip(keys, out):
                self.cache.put(k, d.remaining_hint if d.mutated
                               else d.observed)
        return np.array([d.allowed for d in out], dtype=bool)


def phase_main_path(rng, card: str):
    from ratelimiter_tpu_torch import RateLimitConfig
    from ratelimiter_tpu_torch.algorithms import (
        SlidingWindowRateLimiter,
        TokenBucketRateLimiter,
    )
    from ratelimiter_tpu_torch.metrics import MeterRegistry
    from ratelimiter_tpu_torch.ops.cuda import block_scatter, solver
    from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage

    clock = {"t": 1_760_000_000_000}
    storage = GpuBatchedStorage(num_slots=NUM_SLOTS,
                                clock_ms=lambda: clock["t"])
    check(storage.device.type == "cuda", "storage is not on the card")
    registry = MeterRegistry()
    limiters = {}
    for name, (algo, kw) in TRIO.items():
        cfg = RateLimitConfig(**kw)
        limiters[name] = (SlidingWindowRateLimiter(
            storage, cfg, registry, clock_ms=lambda: clock["t"])
            if algo == "sw" else TokenBucketRateLimiter(storage, cfg,
                                                        registry))
    names = list(TRIO)

    # Inputs, made up front so the timed drives run only the port.
    single = []
    for i in range(N_SINGLE):
        dt = int(rng.integers(0, 40))
        if i == N_SINGLE // 3:
            dt = 61_000                    # into the next window
        if i == 2 * N_SINGLE // 3:
            dt = -5_000                    # the clock steps backward once
        name = names[i % 3]
        permits = (int(rng.integers(1, 101)) if name == "burst"
                   else int(rng.integers(1, 4)))
        single.append((dt, name, f"user{zipf_keys(rng, 1)[0]}", permits))
    bursts = []
    for b in range(N_BURSTS):
        name = names[b % 3]
        keys = [f"user{k}" for k in zipf_keys(rng, BURST)]
        permits = (rng.integers(1, 101, BURST) if name == "burst"
                   else rng.integers(1, 4, BURST))
        bursts.append((int(rng.integers(1_000, 30_000)), name, keys,
                       permits))

    solver.launches = 0
    block_scatter.launches = 0
    log = []  # (kind, name, keys/key, permits, clock) in drive order
    lat = []
    t_single = time.perf_counter()
    for dt, name, key, permits in single:
        clock["t"] += dt
        t0 = time.perf_counter()
        allowed = limiters[name].try_acquire(key, permits)
        lat.append(time.perf_counter() - t0)
        log.append(("one", name, key, permits, clock["t"], allowed))
    t_single = time.perf_counter() - t_single
    t_burst = time.perf_counter()
    for dt, name, keys, permits in bursts:
        clock["t"] += dt
        allowed = limiters[name].try_acquire_many(keys, permits)
        log.append(("many", name, keys, permits, clock["t"], allowed))
    torch.cuda.synchronize()
    t_burst = time.perf_counter() - t_burst
    launches = {"solver": solver.launches,
                "block_scatter": block_scatter.launches}
    check(launches["solver"] > 0 and launches["block_scatter"] > 0,
          f"a kernel was not launched on the main path: {launches}")

    # Replay through the reference, on the storage's monotonic stamps.
    replay = {"t": 0, "stamp": 0}

    def stamp(now):
        replay["stamp"] = max(replay["stamp"], now)
        return replay["stamp"]

    refs = {name: Reference(algo, RateLimitConfig(**kw),
                            lambda: replay["t"], stamp)
            for name, (algo, kw) in TRIO.items()}
    n_checked = n_allowed = 0
    for kind, name, keys, permits, now, allowed in log:
        replay["t"] = now
        if kind == "one":
            want = refs[name].one(keys, permits)
            check(allowed == want, f"try_acquire {name} {keys} x{permits} "
                  f"at {now}: port {allowed}, oracle {want}")
            n_checked += 1
            n_allowed += int(allowed)
        else:
            want = refs[name].many(keys, permits)
            bad = int((np.asarray(allowed) != want).sum())
            check(bad == 0, f"try_acquire_many {name}: {bad} decisions "
                  "differ from the oracle")
            n_checked += len(keys)
            n_allowed += int(np.sum(allowed))
    check(storage.backward_clamps >= 1, "the backward clock step was not "
          "absorbed by the stamp clamp")
    for name in names:
        for key in {k for _, nm, k, _ in single[:50] if nm == name}:
            got = limiters[name].get_available_permits(key)
            want = refs[name].oracle.get_available_permits(
                key, stamp(clock["t"]))
            check(got == want, f"available {name} {key}: {got} != {want}")
    lat_ms = np.array(lat) * 1e3
    print(f"main path ({card}): {N_SINGLE} try_acquire in {t_single:.3f} s "
          f"= {N_SINGLE / t_single:.1f} decisions/s, latency p50 "
          f"{np.percentile(lat_ms, 50):.4f} ms p99 "
          f"{np.percentile(lat_ms, 99):.4f} ms")
    print(f"main path ({card}): {N_BURSTS} try_acquire_many bursts of "
          f"{BURST} in {t_burst:.3f} s = "
          f"{N_BURSTS * BURST / t_burst:.1f} decisions/s")
    print(f"main path: {n_checked} decisions equal to the oracle "
          f"({n_allowed} allowed); launches {launches}")
    return storage, launches


# -- phase 4: where a micro step's time goes ---------------------------------
def phase_step_breakdown(storage, rng, card: str):
    from torch.profiler import ProfilerActivity, profile

    from ratelimiter_tpu_torch.engine.engine import MICRO_STAGE_ROWS

    eng = storage.engine
    lid = 3  # the burst token bucket (registered third)

    def staged_batch(n):
        staged = np.empty((MICRO_STAGE_ROWS, n), dtype=np.int64)
        staged[0] = zipf_keys(rng, n)
        staged[1] = lid
        staged[2] = rng.integers(1, 101, n)
        staged[3, 0] = 1_760_000_500_000
        return staged

    for n in (32, 8192):
        host, dev_t, drain, busy = [], [], [], []
        for rep in range(40):
            staged = staged_batch(n)
            torch.cuda.synchronize()
            if rep >= 30:
                # Behind a sleep backlog the card runs the step's kernels
                # back to back: the events then time its device work alone.
                torch.cuda._sleep(int(statistics.median(host) * 3e-3 * 2e9))
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            handle = eng.micro_staged_dispatch("tb", staged, n)
            end.record()
            t1 = time.perf_counter()
            eng.micro_staged_drain("tb", handle, n)
            t2 = time.perf_counter()
            if rep >= 30:
                busy.append(start.elapsed_time(end))
                continue
            host.append((t1 - t0) * 1e3)
            drain.append((t2 - t1) * 1e3)
            dev_t.append(start.elapsed_time(end))
        # Host-side op count of one step (CPU activity only: torch ops
        # as the host issues them).
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            eng.micro_staged_drain(
                "tb", eng.micro_staged_dispatch("tb", staged, n), n)
        ops = sum(1 for e in prof.events() if e.name.startswith("aten::")
                  and not (e.cpu_parent is not None
                           and e.cpu_parent.name.startswith("aten::")))
        print(f"step breakdown ({card}) tb lanes {n}: host enqueue "
              f"{statistics.median(host):.4f} ms, device span "
              f"{statistics.median(dev_t):.4f} ms, drain wait "
              f"{statistics.median(drain):.4f} ms (medians of 30); device "
              f"work behind a backlog {statistics.median(busy):.4f} ms "
              f"(median of 10); {ops} top-level torch ops per step")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from ratelimiter_tpu_torch.ops.cuda import build

    dev = torch.device("cuda")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    build.build()
    for name in build.KERNELS:
        build.load(name)
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(build.KERNELS)})")

    rng = np.random.default_rng(SEED)
    kernels = phase_kernels(rng, dev)
    storage, launches = phase_main_path(rng, card)
    phase_step_breakdown(storage, rng, card)
    storage.close()

    meta = {
        "solver": ("ratelimiter_tpu_torch/ops/cuda/solver.cu",
                   "ratelimiter_tpu/ops/pallas/solver.py:141"),
        "block_scatter": ("ratelimiter_tpu_torch/ops/cuda/block_scatter.cu",
                          "ratelimiter_tpu/ops/pallas/block_scatter.py:113"),
    }
    line = {"kernels": [{
        "name": name, "route": "cuda", "source": src, "replaces": rep,
        "launches": launches[name], "max_abs_err": kernels[name]["err"],
        "ms": kernels[name]["ms"], "plain_ms": kernels[name]["plain_ms"],
        "bound_ms": kernels[name]["bound_ms"],
        "bound_by": kernels[name]["bound_by"],
        "library_ms": kernels[name]["library_ms"],
    } for name, (src, rep) in meta.items()]}
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
