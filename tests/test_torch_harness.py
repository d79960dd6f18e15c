"""The port's benchmark harness (``ratelimiter_tpu_torch/bench/harness.py``)
against the JAX package's (``ratelimiter_tpu/bench/harness.py``), on the
CPU.

- ``uniform_stream`` and ``zipf_stream`` give byte-equal streams on one
  seed; ``_pcts`` gives equal percentiles on seeded arrays.
- ``bench_end_to_end``, ``bench_end_to_end_stream`` (``reps=2``, with the
  storage: per-pass ``stream_stats``) and ``bench_threaded`` (2 threads)
  run each package's harness over its own storage (the reference's
  ``TpuBatchedStorage``, the port's ``GpuBatchedStorage(device="cpu")``,
  4096 slots, one host index) on one frozen clock: the result dicts have
  the same keys and the same decision counts, the stream passes' records
  the same (``path``, ``mode``, ``n``, ``u``), and afterwards both
  storages hold byte-equal rows for every key the runs touched.
"""

import numpy as np
import pytest
import torch

from ratelimiter_tpu.algorithms import (
    SlidingWindowRateLimiter as RefSW,
    TokenBucketRateLimiter as RefTB,
)
from ratelimiter_tpu.algorithms import token_bucket as ref_tb_mod
from ratelimiter_tpu.bench import harness as ref_harness
from ratelimiter_tpu.core.config import RateLimitConfig as RefConfig
from ratelimiter_tpu.metrics import MeterRegistry as RefRegistry
from ratelimiter_tpu.storage.tpu import TpuBatchedStorage
from ratelimiter_tpu_torch import RateLimitConfig
from ratelimiter_tpu_torch.algorithms import (
    SlidingWindowRateLimiter,
    TokenBucketRateLimiter,
)
from ratelimiter_tpu_torch.algorithms import token_bucket as tb_mod
from ratelimiter_tpu_torch.bench import harness
from ratelimiter_tpu_torch.metrics import MeterRegistry
from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage
from torch_reference_native import (  # noqa: F401 (autouse fixture)
    idle_reference_flushers,
    require_reference_native,
)

torch.set_num_threads(1)

T0 = 1_700_000_000_000
SLOTS = 4096
TB = dict(max_permits=30, window_ms=60_000, refill_rate=10.0)
SW = dict(max_permits=15, window_ms=60_000, enable_local_cache=False)


@pytest.mark.parametrize("seed", [0, 20251016])
def test_key_streams_byte_equal(seed):
    for args in ((1_000, 5_000), (1 << 20, 4_096)):
        a = ref_harness.uniform_stream(np.random.default_rng(seed), *args)
        b = harness.uniform_stream(np.random.default_rng(seed), *args)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    for args in ((1_000, 5_000), (100_000, 4_096, 1.3)):
        a = ref_harness.zipf_stream(np.random.default_rng(seed), *args)
        b = harness.zipf_stream(np.random.default_rng(seed), *args)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_percentiles_equal():
    rng = np.random.default_rng(9)
    for n in (1, 7, 1_000):
        lat = rng.exponential(300.0, n)
        assert harness._pcts(lat) == ref_harness._pcts(lat)


def _same_keys(a: dict, b: dict, path="") -> None:
    assert set(a) == set(b), path
    for k, v in a.items():
        if isinstance(v, dict):
            _same_keys(v, b[k], f"{path}.{k}")


class Side:
    """One package's storage and limiters on the frozen clock."""

    def __init__(self, ref: bool):
        clock = lambda: T0  # noqa: E731
        if ref:
            self.st = TpuBatchedStorage(num_slots=SLOTS, clock_ms=clock,
                                        observability=False, host_parallel=0)
            reg, cfg, tb, sw = RefRegistry(), RefConfig, RefTB, RefSW
            self.h = ref_harness
        else:
            self.st = GpuBatchedStorage(num_slots=SLOTS, clock_ms=clock,
                                        device="cpu", host_parallel=0)
            reg, cfg, tb = MeterRegistry(), RateLimitConfig, TokenBucketRateLimiter
            sw = SlidingWindowRateLimiter
            self.h = harness
        self.tb = tb(self.st, cfg(**TB), reg)
        self.sw = sw(self.st, cfg(**SW), reg, clock_ms=clock)

    def row(self, algo: str, key: str):
        lid = (self.tb if algo == "tb" else self.sw)._lid
        slot = self.st._index[algo].get((lid, key))
        return (None if slot is None
                else np.asarray(self.st.engine.read_rows(algo, [slot])[0]))


def test_harness_runs_match_reference(monkeypatch):
    for mod in (ref_tb_mod, tb_mod):
        monkeypatch.setattr(mod, "_STREAM_MIN", 256)
    require_reference_native()
    rng = np.random.default_rng(20251016)
    ids = harness.zipf_stream(rng, 1_500, 3_000)
    keys = [f"k{i}" for i in ids]
    permits = rng.integers(1, 4, len(keys))
    sides = [Side(True), Side(False)]
    try:
        res = []
        for s in sides:
            e2e = s.h.bench_end_to_end(s.tb, keys[:1_000], permits[:1_000],
                                       200)
            stream = s.h.bench_end_to_end_stream(
                s.tb, keys, None, latency_batch=256, latency_batches=2,
                storage=s.st, reps=2)
            threaded = s.h.bench_threaded(
                s.sw, lambda t: [f"t{t}-{i}" for i in range(4)], 2, 100)
            res.append((e2e, stream, threaded))
        for want, got in zip(*res):
            _same_keys(want, got)
            assert got["decisions"] == want["decisions"]
            assert got["mode"] == want["mode"]
        want, got = res[0][1], res[1][1]
        assert len(got["passes"]) == len(want["passes"]) == 2
        for pw, pg in zip(want["passes"], got["passes"]):
            _same_keys(pw, pg)
            assert [(r["path"], r.get("mode"), r["n"], r.get("u"))
                    for r in pg["stats"]] == [
                (r["path"], r.get("mode"), r["n"], r.get("u"))
                for r in pw["stats"]]
            assert pg["stats"] and all("pack_s" in r for r in pg["stats"])
        assert res[1][2]["request_latency"]["n_samples"] == 200
        touched = {("tb", k) for k in keys} | {
            ("sw", f"t{t}-{i}") for t in range(2) for i in range(4)}
        for algo, key in sorted(touched):
            a, b = (s.row(algo, key) for s in sides)
            assert a is not None and b is not None, key
            assert a.tobytes() == b.tobytes(), key
    finally:
        for s in sides:
            s.st.close()
