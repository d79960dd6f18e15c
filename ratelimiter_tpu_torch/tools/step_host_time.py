#!/usr/bin/env python3
"""Host time of one micro step, for this checkout and another, side by side.

The step is ``chip_smoke.py``'s phase 4: a staged batch of Zipf(1.1) slots
over 1M (the token bucket's permits in [1, 100], the sliding window's in
[1, 3]) through ``DeviceEngine.micro_staged_dispatch`` on a 1M-slot
``GpuBatchedStorage`` holding the service's api / auth / burst limiters.
Each run is a fresh process on one checkout; the runs go other, this,
this, other, repeated ``--rounds`` times, so that drift on the host falls
on both alike.  Per run, algorithm and batch size it reports:

- ``enqueue_ms``: wall time of the dispatch on an idle card (the card is
  synchronized before each step), median over ``STEPS`` steps;
- ``ops_ms``: the CPU profiler's time of the dispatch's top-level torch
  ops, each with the ops it calls, summed per step (median over
  ``PROFILED`` steps): the host time spent inside torch, which Python
  between the ops does not reach;
- ``dispatch_ms``: the profiled dispatch's own time, and ``ops``: the
  count of its top-level torch ops.

Run from a checkout, on a machine with the card::

    python3 ratelimiter_tpu_torch/tools/step_host_time.py --other DIR

``DIR`` is another checkout of the repository, for example the parent
commit unpacked with ``git archive``.  Each run prints one JSON line; the
last lines are the medians over runs per checkout.  ``--device cpu`` runs
the same on the CPU, as a dry run of the script.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
SEED = 20251016
NUM_SLOTS = 1 << 20
NOW_MS = 1_760_000_500_000
# chip_smoke.py's TRIO, registered in its order: api (sliding window) is
# limiter 1, auth 2, burst (token bucket) 3.
TRIO = (
    ("sw", dict(max_permits=100, window_ms=60_000, enable_local_cache=True,
                local_cache_ttl_ms=100)),
    ("sw", dict(max_permits=10, window_ms=60_000, enable_local_cache=False)),
    ("tb", dict(max_permits=50, window_ms=60_000, refill_rate=10.0)),
)
# algorithm: (limiter id, exclusive top of the permits drawn)
STEP_KINDS = {"tb": (3, 101), "sw": (1, 4)}
SIZES = (32, 8192)       # requests per step, as in phase 4
STEPS = 300              # timed steps per run, algorithm and size
PROFILED = 100           # profiled steps per run, algorithm and size
POOL = 16                # staged batches, cycled


def measure(root: Path, device: str):
    """One run on the checkout at ``root``: a dict per algorithm and batch
    size."""
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from ratelimiter_tpu_torch import RateLimitConfig
    from ratelimiter_tpu_torch.algorithms import (
        SlidingWindowRateLimiter,
        TokenBucketRateLimiter,
    )
    from ratelimiter_tpu_torch.engine.engine import MICRO_STAGE_ROWS
    from ratelimiter_tpu_torch.metrics import MeterRegistry
    from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage

    on_card = device == "cuda"
    if on_card:
        from ratelimiter_tpu_torch.ops.cuda import build
        build.build()

    def sync():
        if on_card:
            torch.cuda.synchronize()

    storage = GpuBatchedStorage(num_slots=NUM_SLOTS, clock_ms=lambda: NOW_MS,
                                device=device)
    registry = MeterRegistry()
    for algo, kw in TRIO:
        cfg = RateLimitConfig(**kw)
        if algo == "sw":
            SlidingWindowRateLimiter(storage, cfg, registry,
                                     clock_ms=lambda: NOW_MS)
        else:
            TokenBucketRateLimiter(storage, cfg, registry)
    eng = storage.engine
    rng = np.random.default_rng(SEED)

    def staged_batch(algo, n):
        lid, top = STEP_KINDS[algo]
        cap = max(1 << max(n - 1, 0).bit_length(), 32)
        staged = np.empty((MICRO_STAGE_ROWS, cap), dtype=np.int64)
        staged[0], staged[1], staged[2] = -1, 0, 1
        staged[0, :n] = (rng.zipf(1.1, n) - 1) % NUM_SLOTS
        staged[1, :n] = lid
        staged[2, :n] = rng.integers(1, top, n)
        staged[3, 0] = NOW_MS
        return staged

    out = []
    for algo in STEP_KINDS:
        for n in SIZES:
            pool = [staged_batch(algo, n) for _ in range(POOL)]
            enqueue = []
            for rep in range(STEPS + POOL):
                sync()
                t0 = time.perf_counter()
                handle = eng.micro_staged_dispatch(algo, pool[rep % POOL], n)
                t1 = time.perf_counter()
                eng.micro_staged_drain(algo, handle, n)
                if rep >= POOL:            # the first pass warms up
                    enqueue.append((t1 - t0) * 1e3)
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                for rep in range(PROFILED):
                    sync()
                    with record_function("step_dispatch"):
                        handle = eng.micro_staged_dispatch(
                            algo, pool[rep % POOL], n)
                    eng.micro_staged_drain(algo, handle, n)
            ops_us, dispatch_us, counts = [], [], []
            for ev in prof.events():
                if ev.name != "step_dispatch":
                    continue
                top = [c for c in ev.cpu_children
                       if c.name.startswith("aten::")]
                ops_us.append(sum(c.cpu_time_total for c in top))
                dispatch_us.append(ev.cpu_time_total)
                counts.append(len(top))
            out.append({
                "algo": algo, "n": n,
                "enqueue_ms": statistics.median(enqueue),
                "ops_ms": statistics.median(ops_us) / 1e3,
                "dispatch_ms": statistics.median(dispatch_us) / 1e3,
                "ops": statistics.median(counts),
                "profiled_steps": len(ops_us),
            })
    storage.close()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path,
                    help="the other checkout (runs first of each round)")
    ap.add_argument("--measure", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()

    if args.measure is not None:
        print(json.dumps(measure(args.measure, args.device)))
        return 0

    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("step_host_time: no CUDA device", file=sys.stderr)
            return 1
    trees = {"this": HERE}
    if args.other is not None:
        trees = {"other": args.other.resolve(), "this": HERE}
    order = [t for _ in range(args.rounds)
             for t in (("other", "this", "this", "other")
                       if "other" in trees else ("this",))]
    runs = {name: [] for name in trees}
    for i, name in enumerate(order):
        res = subprocess.run(
            [sys.executable, __file__, "--measure", str(trees[name]),
             "--device", args.device],
            capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            print(res.stderr, file=sys.stderr)
            return res.returncode
        rows = json.loads(res.stdout.strip().splitlines()[-1])
        runs[name].append(rows)
        print(json.dumps({"run": i, "tree": name, "root": str(trees[name]),
                          "steps": rows}))
    for name, rs in runs.items():
        for k, row in enumerate(rs[0]):
            med = {key: statistics.median(r[k][key] for r in rs)
                   for key in ("enqueue_ms", "ops_ms", "dispatch_ms", "ops")}
            print(json.dumps({"tree": name, "algo": row["algo"],
                              "n": row["n"], "runs": len(rs),
                              "median_of_runs": med,
                              "enqueue_ms_per_run": [r[k]["enqueue_ms"]
                                                     for r in rs],
                              "ops_ms_per_run": [r[k]["ops_ms"]
                                                 for r in rs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
