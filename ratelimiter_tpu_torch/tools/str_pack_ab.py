#!/usr/bin/env python3
"""The string stream with its one-join key packer against the per-key one.

``native_index._pack_str_keys`` packs a batch of str keys without NUL
characters in one join, encode and separator scan, and any other batch key
by key (``_pack_keys_each``), to the same bytes.  This script measures what
the join buys on the traffic ``chip_smoke.py``'s phase 8 drives
(``bench/profile_stream_r5.py``'s string deployment): a token bucket of 100
per 60 s refilled at 50/s on 2_000_128 slots, 1M bounded-Zipf(1.1) keys
written as ``f"k{i}"``, passes of 2^21 requests through
``TokenBucketRateLimiter.try_acquire_many`` (which takes
``acquire_stream_strs``), on the host index the storage elects.

First the packers alone: both pack the pass's keys in turns, five times
each, and must give the same bytes.  Then the stream runs go join, each,
each, join, each on a fresh storage with the same keys and clock, in one
process on one card (a first run, dropped, pays for first use).  Per run:
a warm pass (its decisions must equal every other run's) and three timed
passes (decisions/s; the hashing seconds, ``pack_s``, and the assign
seconds summed over the pass's chunks).  The last line is a JSON summary.

Run from a checkout, on a machine with the card::

    python3 ratelimiter_tpu_torch/tools/str_pack_ab.py

``--device cpu --keys 20000 --slots 131072 --requests 65536`` runs the same
at a small size on the CPU, as a dry run of the script.
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
    TokenBucketRateLimiter,
)
from ratelimiter_tpu_torch.engine import native_index  # noqa: E402
from ratelimiter_tpu_torch.metrics import MeterRegistry  # noqa: E402
from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage  # noqa: E402

SEED = 20261017
TB = dict(max_permits=100, window_ms=60_000, refill_rate=50.0)
PACKERS = {"join": native_index._pack_str_keys,
           "each": native_index._pack_keys_each}
ORDER = ("join", "each", "each", "join")


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({exc})"


def zipf_keys(rng, num_keys: int, n: int, a: float = 1.1) -> list:
    """``n`` bounded Zipf(a) draws over ``num_keys`` keys, as ``f"k{i}"``."""
    probs = np.arange(1, num_keys + 1, dtype=np.float64) ** (-a)
    probs /= probs.sum()
    return [f"k{i}" for i in rng.choice(num_keys, size=n, p=probs).tolist()]


def packers_alone(keys: list, card: str) -> dict:
    """Each packer over ``keys``, in turns, five times each: ns a key."""
    want = None
    times = {name: [] for name in PACKERS}
    for _ in range(5):
        for name, pack in PACKERS.items():
            t0 = time.perf_counter()
            data, offsets = pack(keys)
            times[name].append((time.perf_counter() - t0) / len(keys) * 1e9)
            if want is None:
                want = (data, offsets)
            elif not (np.array_equal(data, want[0])
                      and np.array_equal(offsets, want[1])):
                raise AssertionError(f"{name}: packed bytes differ")
    for name, ns in times.items():
        print(f"packer {name} ({card}): {len(keys)} keys, "
              f"{[round(v, 1) for v in ns]} ns a key, median "
              f"{statistics.median(ns):.1f}")
    return {name: statistics.median(ns) for name, ns in times.items()}


def run(packer: str, keys: list, slots: int, device: str, card: str):
    """One fresh storage whose string hashing packs with ``packer``: its
    warm-pass decisions and a dict of its numbers."""
    native_index._pack_str_keys = PACKERS[packer]
    try:
        clock = {"t": 1_760_700_000_000}
        storage = GpuBatchedStorage(num_slots=slots,
                                    clock_ms=lambda: clock["t"],
                                    device=device)
        lim = TokenBucketRateLimiter(storage, RateLimitConfig(**TB),
                                     MeterRegistry())

        def one_pass():
            out = lim.try_acquire_many(keys)
            if device == "cuda":
                torch.cuda.synchronize()
            chunks = storage.last_stream_chunks
            if not chunks or any("pack_s" not in rec for rec in chunks):
                raise AssertionError(f"{packer} run: chunks {chunks}")
            return np.asarray(out)

        warm = one_pass().copy()
        rates, pack_s, assign_s = [], [], []
        for p in range(3):
            clock["t"] += 1_000
            t0 = time.perf_counter()
            allowed = one_pass()
            wall = time.perf_counter() - t0
            chunks = storage.last_stream_chunks
            rates.append(len(keys) / wall)
            pack_s.append(sum(rec["pack_s"] for rec in chunks))
            assign_s.append(sum(rec["assign_s"] for rec in chunks))
            print(f"{packer} pass {p} ({card}): {len(keys)} requests in "
                  f"{wall:.6f} s = {rates[-1]:.1f} decisions/s, "
                  f"{int(allowed.sum())} allowed; hashing {pack_s[-1]:.6f} "
                  f"s of assign {assign_s[-1]:.6f} s over {len(chunks)} "
                  f"chunks (host_parallel {storage._host_parallel})")
        storage.close()
        return warm, {"median_rate": statistics.median(rates),
                      "median_pack_s": statistics.median(pack_s),
                      "median_assign_s": statistics.median(assign_s)}
    finally:
        native_index._pack_str_keys = PACKERS["join"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--keys", type=int, default=1_000_000)
    ap.add_argument("--slots", type=int, default=2_000_128)
    ap.add_argument("--requests", type=int, default=1 << 21)
    args = ap.parse_args()

    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("str_pack_ab: no CUDA device", file=sys.stderr)
            return 1
        from ratelimiter_tpu_torch.ops.cuda import build
        build.build()
    card = card_line() if args.device == "cuda" else "cpu"
    print(f"card: {card}")
    keys = zipf_keys(np.random.default_rng(SEED), args.keys, args.requests)
    alone = packers_alone(keys, card)
    run("join", keys, args.slots, args.device, card)  # first use, dropped
    warm0, runs = None, {name: [] for name in PACKERS}
    for packer in ORDER:
        warm, res = run(packer, keys, args.slots, args.device, card)
        if warm0 is None:
            warm0 = warm
        elif not np.array_equal(warm, warm0):
            print(f"{packer}: warm-pass decisions differ from the first "
                  "run's", file=sys.stderr)
            return 1
        runs[packer].append(res)
    summary = {"card": card, "requests": args.requests, "keys": args.keys,
               "slots": args.slots, "packer_ns_per_key": alone}
    for packer, rs in runs.items():
        summary[packer] = {k: [r[k] for r in rs] for k in rs[0]}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
