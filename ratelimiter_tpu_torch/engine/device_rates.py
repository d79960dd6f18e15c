"""Measured device step rates for the stream loops' cost models
(counterpart of ``ratelimiter_tpu/engine/device_rates.py``).

Under a link profile the chunk-plan election and the words-or-digest
election charge the device step explicitly (``storage/gpu.py``).  This
module measures those charges on the device the storage runs on: a
chain of K = 16 steps at the reference's shapes (2^19 slots, 2^17 lanes,
rank_bits 8), timed with CUDA events around the chain as it is enqueued
(the host clock on a CPU device), so a rate is what a step costs the
stream loop, the larger of the host's enqueue and the card's work:

- ``s_per_lane``: words mode (``ops/relay.py:tb_relay_bits``), a
  request a lane;
- ``s_per_unique_sorted`` / ``s_per_unique_unsorted``: the digest
  (``ops/relay.py:tb_relay_counts``, on the card the ``relay_step.cu``
  kernel) over slot-sorted and shuffled words, a unique a lane.

A probe runs once per (platform, device name) and is cached in the
process and on disk, in ``build/device_rates/<platform>_<name>.json``
(git-ignored, written through ``os.replace``), so later processes read it.
``RATELIMITER_RATE_PROBE=0`` opts out: the fallback constants below are
returned, and the opt-out beats the disk cache, as the reference's does.
Rates come back as a dict with the three keys and ``source`` ("probe" or
"fallback"), ``device`` and, for a probe, ``probed_at_ms``.

Two departures from the reference (ROADMAP port rules):

- The fallback constants are the H100's, measured by ``chip_smoke.py``
  phase 21 (a), not the reference's TPU figures.
- A probe that fails raises: nothing falls back quietly.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Dict

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
CACHE_DIR = REPO / "build" / "device_rates"

# Measured on an NVIDIA H100 80GB HBM3, power limit 700.00 W, by the probe
# below (``chip_smoke.py`` phase 21 (a)): seconds a lane of the words
# step, and a unique of the digest over sorted and shuffled slots.  Each
# is the larger of the host's enqueue and the card's work a step.
FALLBACK_RATES: Dict[str, float] = {
    "s_per_lane": 8.81e-9,
    "s_per_unique_sorted": 8.82e-10,
    "s_per_unique_unsorted": 8.20e-10,
}

PROBE_SLOTS = 1 << 19
PROBE_LANES = 1 << 17
PROBE_STEPS = 16
PROBE_RANK_BITS = 8

_mem_cache: Dict[str, Dict] = {}


def _device_name(dev: torch.device) -> str:
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def _cache_path(platform: str, name: str) -> Path:
    safe = "".join(ch if ch.isalnum() else "_" for ch in name)[:40]
    return CACHE_DIR / f"{platform}_{safe}.json"


def _as_words(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(arr.astype(np.uint32).view(np.int32)).to(dev)


def _probe(dev: torch.device) -> Dict[str, float]:
    """Time the three steps on ``dev``: a K-step chain each, run once
    untimed (the kernels' build and first launch) and once timed."""
    from ratelimiter_tpu_torch.core.config import RateLimitConfig
    from ratelimiter_tpu_torch.engine.state import LimiterTable
    from ratelimiter_tpu_torch.ops import relay
    from ratelimiter_tpu_torch.ops.token_bucket import make_tb_packed

    rb = PROBE_RANK_BITS
    table = LimiterTable(device=dev)
    lid = table.register(RateLimitConfig(
        max_permits=100, window_ms=60_000, refill_rate=50.0))
    tarr = table.device_arrays
    lid_dev = torch.tensor(lid, dtype=torch.int64, device=dev)
    base = (np.arange(PROBE_LANES, dtype=np.uint32)
            * np.uint32(PROBE_SLOTS // PROBE_LANES))
    shuf = np.random.default_rng(9).permutation(base).astype(np.uint32)
    words = _as_words((base << np.uint32(rb + 1)) | np.uint32(1), dev)
    uw_sorted = _as_words((base << np.uint32(rb + 1)) | np.uint32(1 << 1),
                          dev)
    uw_shuf = _as_words((shuf << np.uint32(rb + 1)) | np.uint32(1 << 1),
                        dev)

    def bits_step(packed, now):
        return relay.tb_relay_bits(packed, tarr, words, lid_dev, now,
                                   rank_bits=rb)

    def digest_step(uw):
        def step(packed, now):
            return relay.tb_relay_counts(packed, tarr, uw, lid, now,
                                         rank_bits=rb,
                                         out_dtype=torch.uint8)
        return step

    def chain(step, packed, now0):
        acc = torch.zeros((), dtype=torch.int64, device=dev)
        for i in range(PROBE_STEPS):
            acc = acc + step(packed, now0 + i).to(torch.int64).sum()
        return acc

    def measure(step) -> float:
        packed = make_tb_packed(PROBE_SLOTS, dev)
        int(chain(step, packed, 1_000_000).item())  # build + settle
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            chain(step, packed, 2_000_000)
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1000.0
        else:
            t0 = time.perf_counter()
            int(chain(step, packed, 2_000_000).item())
            dt = time.perf_counter() - t0
        return max(dt, 1e-6) / (PROBE_STEPS * PROBE_LANES)

    return {
        "s_per_lane": measure(bits_step),
        "s_per_unique_sorted": measure(digest_step(uw_sorted)),
        "s_per_unique_unsorted": measure(digest_step(uw_shuf)),
    }


def get_device_rates(device=None) -> Dict:
    """Rates for ``device`` (``None``: the card, ``cuda``), probed and
    cached as the module docstring says."""
    dev = torch.device("cuda" if device is None else device)
    platform = dev.type
    name = _device_name(dev)
    key = f"{platform}/{name}"
    hit = _mem_cache.get(key)
    if hit is not None:
        return hit
    # The opt-out beats the disk cache: a run pinning its election
    # inputs (the tests) must get the constants even where a probe left
    # its file.
    if os.environ.get("RATELIMITER_RATE_PROBE", "1") == "0":
        rates = dict(FALLBACK_RATES, source="fallback", device=key)
        _mem_cache[key] = rates
        return rates
    path = _cache_path(platform, name)
    if path.exists():
        rates = json.loads(path.read_text(encoding="utf-8"))
        if all(k in rates for k in FALLBACK_RATES):
            _mem_cache[key] = rates
            return rates
    rates = dict(_probe(dev), source="probe", device=key,
                 probed_at_ms=int(time.time() * 1000))
    _mem_cache[key] = rates
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    tmp.write_text(json.dumps(rates), encoding="utf-8")
    os.replace(tmp, path)
    return rates
