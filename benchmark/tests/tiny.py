"""Cells of ``BENCHMARK.json`` cut to a size the CPU tests can run: the
same configuration and traffic files with fewer keys, slots, calls and
requests."""

from __future__ import annotations

import contextlib

from benchmark.lib import spec


# Cells whose files are here but that BENCHMARK.json does not hold (their
# runs spread too widely for a bound; see PERF.md), run from their files
# with the metrics they would report.
STREAM_LAYERS = ["walk_ns_per_request.stream", "host_ns_per_request.stream",
                 "device_idle_share.stream"]
OTHER_CELLS = {
    "sw_10m_uniform.stream_ids": (
        "sw_10m_uniform", "stream_ids", 1,
        ["stream_decisions_per_s", "setup_s"],
        STREAM_LAYERS + ["relay_step_roofline"]),
    "sw_10m_uniform_x4.stream_ids": (
        "sw_10m_uniform_x4", "stream_ids", 4,
        ["stream_decisions_per_s", "setup_s"],
        STREAM_LAYERS + ["route_ns_per_request.stream"]),
    "sw_10m_uniform.requests_20t": (
        "sw_10m_uniform", "requests_20t", 1,
        ["request_decisions_per_s", "setup_s"],
        ["request_p99_ms.requests", "requests_per_step.requests",
         "device_idle_share.requests"]),
}
UNITS = {"stream_decisions_per_s": "decisions/s",
         "request_decisions_per_s": "decisions/s", "setup_s": "s",
         "request_p99_ms.requests": "ms",
         "requests_per_step.requests": "requests/step",
         "relay_step_roofline": "%"}


def load(name: str) -> dict:
    if name not in OTHER_CELLS:
        return spec.load_cell(name)
    config, traffic, chips, e2e, layers = OTHER_CELLS[name]
    workload = {"name": name, "config": config, "traffic": traffic,
                "chips": chips}
    cell = spec.assemble(workload, f"benchmark/configs/{config}.json",
                         spec.load_benchmark())

    def metric(m):
        return {"name": m, "unit": UNITS.get(m, "%" if "share" in m
                                             else "ns")}
    cell["end_to_end"] = [metric(m) for m in e2e]
    cell["per_layer"] = [metric(m) for m in layers]
    return cell


def tiny_cell(name: str, keys: int = 20000) -> dict:
    cell = load(name)
    cell["config"]["keys"] = keys
    cell["config"]["properties"]["storage.num_slots"] = 1 << 16
    t = cell["traffic"]
    if "call_keys" in t:
        t.update(call_keys=1 << 15, pool_calls=2)
    if "batch" in t.get("entry_kwargs", {}):
        t["entry_kwargs"] = dict(t["entry_kwargs"], batch=1 << 12)
    if "threads" in t:
        t.update(threads=4, requests_per_thread=256, warmup_requests=16,
                 fill_call_keys=1 << 14)
    t["peek"] = dict(t["peek"], random=500,
                     hottest=min(64, t["peek"].get("hottest", 0)))
    return cell


@contextlib.contextmanager
def cpu_shards(n: int):
    """``build_storage`` as on a host of ``n`` cards, each shard on the
    CPU."""
    import torch
    from ratelimiter_tpu_torch.service import wiring

    saved = (wiring.resolve_device, wiring.sharded_engine,
             torch.cuda.device_count)
    orig = wiring.sharded_engine
    wiring.resolve_device = lambda device=None: torch.device("cpu")
    wiring.sharded_engine = lambda props, devices: orig(
        props, [torch.device("cpu")] * len(devices))
    torch.cuda.device_count = lambda: n
    try:
        yield
    finally:
        (wiring.resolve_device, wiring.sharded_engine,
         torch.cuda.device_count) = saved


def run_tiny(name: str, seed: int = 2**31 + 11, seconds: float = 0.6,
             traced: bool = False, hook=None) -> dict:
    """One run of the cut cell on the CPU (a four-card cell on four CPU
    shards)."""
    from benchmark import run

    cell = tiny_cell(name)
    chips = cell["workload"]["chips"]
    if chips > 1:
        with cpu_shards(chips):
            kind = run.device_kind
            run.device_kind = lambda device: "cpu"
            try:
                return run.run_cell(cell, seed, seconds, traced, hook=hook)
            finally:
                run.device_kind = kind
    return run.run_cell(cell, seed, seconds, traced, device="cpu",
                        hook=hook)
