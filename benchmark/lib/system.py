"""The system under test, built as a deployment builds it.

The storage comes from ``ratelimiter_tpu_torch/service/wiring.py:
build_storage`` on the shipped ``application.properties`` with only the
configuration file's ``properties`` over it; then, as ``build_app`` does,
the warm-up of the micro steps (``warmup.enabled``) and the link probe
(``link.probe.enabled``), both on by default.  The storage's clock is the
benchmark's :class:`~benchmark.lib.clock.RecordedClock`, passed through
the storage's ``clock_ms`` argument; every limiter gets it too.

This module is the only one of the harness that imports the program.
"""

from __future__ import annotations

import functools
import importlib
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def properties(overrides: dict):
    """The shipped ``application.properties`` (comments and blank lines
    skipped, ``key=value`` lines), with ``overrides`` over it."""
    from ratelimiter_tpu_torch.service.props import AppProperties

    values = {}
    for line in (ROOT / "application.properties").read_text().splitlines():
        line = line.strip()
        if not line or line.startswith(("#", "!")) or "=" not in line:
            continue
        k, v = line.split("=", 1)
        values[k.strip()] = v.strip()
    values.update({k: str(v) for k, v in overrides.items()})
    return AppProperties(values)


class System:
    """The storage and what the boot elected (``boot``); the drivers
    build the limiters they need over it (:meth:`limiter`)."""

    def __init__(self, config: dict, clock, device=None):
        from ratelimiter_tpu_torch.service import wiring
        from ratelimiter_tpu_torch.storage.gpu import GpuBatchedStorage

        self.clock = clock
        props = properties(config.get("properties", {}))
        built = wiring.GpuBatchedStorage
        wiring.GpuBatchedStorage = functools.partial(GpuBatchedStorage,
                                                     clock_ms=clock)
        try:
            self.storage = wiring.build_storage(props, device=device)
        finally:
            wiring.GpuBatchedStorage = built
        self.boot = {}
        if props.get_bool("warmup.enabled", True):
            self.boot["warmup_s"] = wiring.warmup_shapes(
                self.storage, max_batch=props.get_int("batcher.max_batch",
                                                      8192))
        if props.get_bool("link.probe.enabled", True):
            self.boot["link_profile"] = list(self.storage.probe_link())
        self.boot["host_parallel"] = self.storage._host_parallel
        self.boot["shards"] = getattr(self.storage.engine, "n_shards", 1)
        devices = getattr(self.storage.engine, "devices",
                          [self.storage.device])
        self.devices = [d.index or 0 for d in devices if d.type == "cuda"]

    def limiter(self, config: dict):
        """A limiter of the configuration over the storage: the class its
        ``"limiter_class"`` names (``module.Class``), with its
        ``"limiter"`` settings as a ``RateLimitConfig`` and the benchmark's
        clock as its ``clock_ms``."""
        from ratelimiter_tpu_torch import RateLimitConfig
        from ratelimiter_tpu_torch.metrics import MeterRegistry

        module, _, name = config["limiter_class"].rpartition(".")
        if module.split(".")[0] != "ratelimiter_tpu_torch":
            raise ValueError(f"not a limiter of the port: {module!r}")
        cls = getattr(importlib.import_module(module), name)
        return cls(self.storage, RateLimitConfig(**config["limiter"]),
                   MeterRegistry(), clock_ms=self.clock)

    def plans(self) -> dict:
        """The chunk plans the stream loops elected, by stream shape."""
        return {str(k): {kk: vv for kk, vv in v.items()
                         if isinstance(vv, (int, float, str))}
                for k, v in self.storage._chunk_plans.items()}

    def available(self, algorithm: str, limiter, keys) -> list:
        """``limiter``'s available permits of each key, read by the
        storage's ``algorithm`` (``"tb"``, ``"sw"``; a peek: no state
        changes)."""
        return [int(v) for v in self.storage.available_many(
            algorithm, limiter._lid, keys)]

    def modes(self) -> dict:
        """How many chunks of the last stream call ran in each mode."""
        out = {}
        for c in self.storage.last_stream_chunks:
            mode = str(c.get("mode"))
            out[mode] = out.get(mode, 0) + 1
        return out

    def memory_peak_bytes(self) -> int:
        """The peak of allocated device memory on the fullest card."""
        import torch
        return max((torch.cuda.max_memory_allocated(d)
                    for d in self.devices), default=0)

    def launches(self) -> dict:
        """The kernel wrappers' launch counters (all 0 off the card)."""
        from ratelimiter_tpu_torch.ops.cuda import launch_counts
        return launch_counts()

    def close(self) -> None:
        self.storage.close()
