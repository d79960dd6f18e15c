#!/usr/bin/env python3
"""The relay stream's words mode against its digest, on the same traffic.

The traffic is ``bench.py``'s scenario 3, as ``chip_smoke.py``'s phase 7
(g) drives it: a sliding window of 100/min, local cache off, 10M uniform
keys on 12_500_224 slots, passes of 2^22 requests through
``SlidingWindowRateLimiter.try_acquire_stream_ids``.  On such traffic the
storage's no-profile election picks words mode for every chunk; the
``digest`` runs replace the election with one that always picks the
digest, so the same chunks run the CUDA relay step instead.

The runs go words, digest, digest, words, each on a fresh storage with the
same keys and clock, in one process on one card.  Per run: a warm pass
(its decisions must equal every other run's), three timed passes
(decisions/s, each chunk's mode checked), and one pass under the
profiler's CUDA activity (device time, idle share, the largest device
entries).  The last line is a JSON summary per mode.

Run from a checkout, on a machine with the card::

    python3 ratelimiter_tpu_torch/tools/relay_mode_ab.py

``--device cpu --keys 200000 --slots 262144 --requests 16384`` runs the same
at a small size on the CPU, as a dry run of the script (no profiler).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ratelimiter_tpu_torch import RateLimitConfig  # noqa: E402
from ratelimiter_tpu_torch.algorithms import (  # noqa: E402
    SlidingWindowRateLimiter,
)
from ratelimiter_tpu_torch.metrics import MeterRegistry  # noqa: E402
from ratelimiter_tpu_torch.storage import gpu as gpu_mod  # noqa: E402

SEED = 20261017
SW = dict(max_permits=100, window_ms=60_000, enable_local_cache=False)
ORDER = ("words", "digest", "digest", "words")
MODE_RECORD = {"words": "words", "digest": "relay"}


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({exc})"


def run(mode: str, keys: np.ndarray, slots: int, device: str, card: str):
    """One fresh storage driven in ``mode``: its warm-pass decisions and a
    dict of its numbers."""
    on_card = device == "cuda"
    elect = gpu_mod._elect_digest_mode
    if mode == "digest":
        gpu_mod._elect_digest_mode = lambda *args, **kw: True
    try:
        clock = {"t": 1_760_400_000_000}
        storage = gpu_mod.GpuBatchedStorage(
            num_slots=slots, clock_ms=lambda: clock["t"], device=device)
        lim = SlidingWindowRateLimiter(
            storage, RateLimitConfig(**SW), MeterRegistry(),
            clock_ms=lambda: clock["t"])

        def one_pass():
            out = lim.try_acquire_stream_ids(keys)
            if on_card:
                torch.cuda.synchronize()
            for rec in storage.last_stream_chunks:
                if rec["mode"] != MODE_RECORD[mode]:
                    raise AssertionError(f"{mode} run: chunk {rec}")
            return out

        warm = np.asarray(one_pass()).copy()
        rates = []
        for p in range(3):
            clock["t"] += 1_000
            t0 = time.perf_counter()
            allowed = one_pass()
            wall = time.perf_counter() - t0
            rates.append(len(keys) / wall)
            chunks = storage.last_stream_chunks
            print(f"{mode} pass {p} ({card}): {len(keys)} requests in "
                  f"{wall:.6f} s = {rates[-1]:.1f} decisions/s, "
                  f"{int(np.asarray(allowed).sum())} allowed, "
                  f"{len(chunks)} chunks, uniques "
                  f"{[rec['uniques'] for rec in chunks]}")
        res = {"mode": mode, "rates": rates,
               "median_rate": statistics.median(rates)}
        if on_card:
            res.update(profiled(mode, card, one_pass, clock))
        storage.close()
        return warm, res
    finally:
        gpu_mod._elect_digest_mode = elect


def profiled(mode: str, card: str, one_pass, clock) -> dict:
    """One pass under the profiler's CUDA activity."""
    from torch.profiler import ProfilerActivity, profile

    clock["t"] += 1_000
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_pass()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    busy_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    top_ms = {e.key[:70]: e.self_device_time_total / 1e3 for e in top}
    print(f"{mode} pass under the profiler ({card}): {wall:.6f} s; device "
          f"time {busy_us / 1e3:.4f} ms, idle share "
          f"{1 - busy_us / 1e6 / wall if wall else 0:.6f}; top: "
          + "; ".join(f"{k} {v:.4f} ms" for k, v in top_ms.items()))
    return {"profiled_wall_s": wall, "device_ms": busy_us / 1e3,
            "idle_share": 1 - busy_us / 1e6 / wall, "top_ms": top_ms}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--keys", type=int, default=10_000_000)
    ap.add_argument("--slots", type=int, default=12_500_224)
    ap.add_argument("--requests", type=int, default=1 << 22)
    args = ap.parse_args()

    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("relay_mode_ab: no CUDA device", file=sys.stderr)
            return 1
        from ratelimiter_tpu_torch.ops.cuda import build
        build.build()
    card = card_line() if args.device == "cuda" else "cpu"
    print(f"card: {card}")
    keys = np.random.default_rng(SEED).integers(0, args.keys, args.requests)
    # A run whose numbers are dropped: the process's first passes also pay
    # for the allocator's and the libraries' first use.
    run("words", keys, args.slots, args.device, card)
    warm0, runs = None, {m: [] for m in MODE_RECORD}
    for mode in ORDER:
        warm, res = run(mode, keys, args.slots, args.device, card)
        if warm0 is None:
            warm0 = warm
        elif not np.array_equal(warm, warm0):
            print(f"{mode}: warm-pass decisions differ from the first run's",
                  file=sys.stderr)
            return 1
        runs[mode].append(res)
    summary = {"card": card, "requests": args.requests, "keys": args.keys,
               "slots": args.slots}
    for mode, rs in runs.items():
        summary[mode] = {
            "median_rate_per_run": [r["median_rate"] for r in rs],
            "device_ms_per_run": [r.get("device_ms") for r in rs],
            "idle_share_per_run": [r.get("idle_share") for r in rs],
        }
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
