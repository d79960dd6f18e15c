"""Benchmark harness (counterpart of ``ratelimiter_tpu/bench/harness.py``).

The reference's harness drives N threads of per-request tryAcquire against
live Redis and reports throughput + latency percentiles
(RateLimiterBenchmark scenarios; README publishes 80,192 req/s, p99 578 us
on an M1).  This harness reproduces those scenarios against the port's
backends and the BASELINE.json scenarios (1M-key Zipf token
bucket, 10M-key uniform sliding window, 100K-tenant mix, burst
batch-acquire).  It imports numpy only; the functions, their signatures,
result keys and random draws are the reference's, so one seed gives the
same key streams in both packages.

Measurement modes, reported separately:

- ``end_to_end`` — string keys in, decisions out, through the slot index and
                   storage layer (the number comparable to the reference's
                   throughput figures).
- ``threaded``   — T threads of single tryAcquire through the micro-batcher;
                   per-request wall latencies incl. queue wait -> p50/p95/p99
                   (the number comparable to the reference's latency figures).
- ``end_to_end_stream`` — string keys through the pipelined stream path,
                   with each pass's per-chunk records
                   (``GpuBatchedStorage.stream_stats``).

What warms on the card before a timed pass: the kernels' first build and
load (``ops/cuda/build.py``), the staging pool's buffers of each chunk
shape (``storage/gpu.py:_StagingPool``) and the storage's chunk plans,
which a stream shape's first passes elect.  Every function runs its
warm-up untimed.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List

import numpy as np


def _pcts(lat_us: np.ndarray) -> Dict[str, float]:
    lat = np.sort(lat_us)

    def pct(p):
        return float(lat[min(len(lat) - 1, int(p * len(lat)))])
    return {
        # n_samples makes degenerate upper percentiles visible (p95 == p99
        # means the tail is one sample, not a plateau).
        "n_samples": int(len(lat)),
        "mean_us": float(lat.mean()),
        "p50_us": pct(0.50),
        "p95_us": pct(0.95),
        "p99_us": pct(0.99),
    }


# ---------------------------------------------------------------------------
# Key-stream generators (BASELINE.json configs)
# ---------------------------------------------------------------------------

def uniform_stream(rng, num_keys: int, n: int) -> np.ndarray:
    return rng.integers(0, num_keys, size=n)


def zipf_stream(rng, num_keys: int, n: int, a: float = 1.1) -> np.ndarray:
    """Bounded Zipf(a) keys in [0, num_keys): key k with probability
    proportional to (k + 1)^-a, by inverse CDF over ranks
    (``np.random.zipf`` is unbounded)."""
    ranks = np.arange(1, num_keys + 1, dtype=np.float64)
    probs = ranks ** (-a)
    probs /= probs.sum()
    return rng.choice(num_keys, size=n, p=probs)


# ---------------------------------------------------------------------------
# End-to-end (string keys through storage + slot index)
# ---------------------------------------------------------------------------

def bench_end_to_end(
    limiter,
    key_stream: List[str],
    permits: np.ndarray,
    batch: int,
) -> Dict:
    n = (len(key_stream) // batch) * batch
    # One untimed call at the exact batch shape: the kernels' build, the
    # batch's staged bucket and its keys' first slot assigns stay out of
    # the timed calls.
    limiter.try_acquire_many(key_stream[:batch], permits[:batch])
    lat = []
    t_all = time.perf_counter()
    for i in range(0, n, batch):
        t0 = time.perf_counter()
        limiter.try_acquire_many(key_stream[i:i + batch], permits[i:i + batch])
        lat.append((time.perf_counter() - t0) * 1e6)
    wall = time.perf_counter() - t_all
    return {
        "mode": "end_to_end",
        "decisions": n,
        "batch": batch,
        "wall_s": wall,
        "decisions_per_sec": n / wall,
        "batch_latency": _pcts(np.asarray(lat)),
    }


def bench_end_to_end_stream(
    limiter,
    key_stream: List[str],
    permits: np.ndarray | None,
    latency_batch: int = 1 << 14,
    latency_batches: int = 8,
    storage=None,
    reps: int = 3,
) -> Dict:
    """End-to-end string keys via the pipelined stream path.

    Throughput: ``reps`` timed ``try_acquire_many`` passes over the whole
    stream (above the limiter's stream threshold it routes through
    ``storage.acquire_stream_strs``, overlapping host packing/hashing
    with device fetches); the median pass is the robust figure.  With
    ``storage`` given, each pass records the per-chunk phase lanes
    (pack_s / walk_s / fetch_s) via ``stream_stats``.
    Latency: a handful of synchronous ``latency_batch``-sized calls,
    reported separately — they measure the non-pipelined round trip.
    """
    n = len(key_stream)
    # Full untimed passes (buckets drain, throughput is unaffected) until
    # the storage's chunk-plan map stops changing: an election brings new
    # chunk shapes, and with them new staging buffers and a first pass at
    # the new schedule, so no timed pass meets a fresh shape.  The first
    # pass also builds the kernels.
    def plan_sig():
        if storage is None:
            return None
        return {k: (v["kind"], v.get("schedule", v.get("chunk")))
                for k, v in storage._chunk_plans.items()}

    for i in range(4):
        sig = plan_sig()
        limiter.try_acquire_many(key_stream, permits)
        if i > 0 and plan_sig() == sig:
            break
    limiter.try_acquire_many(key_stream[:latency_batch],
                             None if permits is None
                             else permits[:latency_batch])
    passes = []
    for _ in range(max(reps, 1)):
        stats = None
        if storage is not None:
            storage.stream_stats = stats = []
        t0 = time.perf_counter()
        limiter.try_acquire_many(key_stream, permits)
        wall = time.perf_counter() - t0
        if storage is not None:
            storage.stream_stats = None
        passes.append({"wall_s": round(wall, 4),
                       "decisions_per_sec": round(n / wall, 1),
                       "stats": stats})
    lat = []
    for i in range(latency_batches):
        j = (i * latency_batch) % max(n - latency_batch, 1)
        t1 = time.perf_counter()
        limiter.try_acquire_many(
            key_stream[j:j + latency_batch],
            None if permits is None else permits[j:j + latency_batch])
        lat.append((time.perf_counter() - t1) * 1e6)
    total_wall = sum(p["wall_s"] for p in passes)
    rates = sorted(p["decisions_per_sec"] for p in passes)
    return {
        "mode": "end_to_end_stream",
        "decisions": n * len(passes),
        "wall_s": round(total_wall, 4),
        "decisions_per_sec": n * len(passes) / total_wall,
        "median_pass_decisions_per_sec": rates[len(rates) // 2],
        "best_pass_decisions_per_sec": rates[-1],
        "passes": passes,
        "batch": latency_batch,
        "batch_latency": _pcts(np.asarray(lat)),
    }


# ---------------------------------------------------------------------------
# Threaded single-request latency (through the micro-batcher)
# ---------------------------------------------------------------------------

def bench_threaded(
    limiter,
    keys_per_thread: Callable[[int], List[str]],
    n_threads: int,
    requests_per_thread: int,
) -> Dict:
    lat = np.zeros((n_threads, requests_per_thread))
    barrier = threading.Barrier(n_threads)

    def worker(t):
        my_keys = keys_per_thread(t)
        barrier.wait()
        for i in range(requests_per_thread):
            t0 = time.perf_counter()
            limiter.try_acquire(my_keys[i % len(my_keys)])
            lat[t, i] = (time.perf_counter() - t0) * 1e6

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(n_threads)]
    t_all = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t_all
    total = n_threads * requests_per_thread
    return {
        "mode": "threaded",
        "threads": n_threads,
        "decisions": total,
        "wall_s": wall,
        "decisions_per_sec": total / wall,
        "request_latency": _pcts(lat.reshape(-1)),
    }
