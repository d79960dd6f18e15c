#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the cards of this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``.  Set-up
builds the system from the cell's configuration (``lib/system.py``),
draws the cell's traffic from the seed (``lib/drivers.py``), fills and
warms it; the window then drives the traffic for ``--seconds``.  With
``--trace 0`` the result holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read by ``metrics/<name>.py`` from
the window's stream records, the launch counters and a device trace of
a fixed part of the window.  After the window the program's state is
read back and the storage closed; the reference then decides every
request again (``lib/check.py``).  The traffic file names its driver
(``drivers/<driver>.py``), the configuration its reference
(``reference/<reference>.py``): the run itself knows no entry, limiter
or algorithm.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared with its
limit.  The last lines of standard error are the same numbers.  Exit
codes: 0 with a result; 1 without a card (or fewer than the cell's);
2 for an unknown cell; 3 if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import resource  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from benchmark.lib import check, spec  # noqa: E402
from benchmark.lib.clock import RecordedClock  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "ratelimiter_tpu")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def seed_entropy(seed: int) -> int:
    return int(seed) % (1 << 64)


def run_cell(cell: dict, seed: int, seconds: float, traced: bool, *,
             device=None, hook=None, t_start: float = T_START) -> dict:
    """One run of ``cell`` (:func:`spec.load_cell`); returns the result
    object.  ``device`` None serves on the cards as a deployment does;
    ``hook(system, driver)``, where given, runs before set-up (the tests
    break the timed path there)."""
    from benchmark.lib.system import System

    name = cell["workload"]["name"]
    config, traffic = cell["config"], cell["traffic"]
    entropy = seed_entropy(seed)
    rng = np.random.default_rng(entropy)
    clock = RecordedClock()
    system = System(config, clock, device=device)
    log(f"[{name}] boot: {json.dumps(system.boot)}")
    driver = spec.driver(traffic["driver"])(system, config, traffic, rng,
                                            clock)
    if hook is not None:
        hook(system, driver)
    driver.setup()
    # The set-up's garbage (fill keys, warm-up results) is collected
    # before the window rather than in it.
    gc.collect()
    log(f"[{name}] set-up elected plans {json.dumps(system.plans())}, "
        f"last call's chunk modes {json.dumps(system.modes())}")
    marks = {}

    def first():
        marks["setup_s"] = time.perf_counter() - t_start

    host = HostMeter()
    w = driver.window(seconds, traced, first)
    log(f"[{name}] host over the window: {json.dumps(host.read())}")
    peak = system.memory_peak_bytes()
    if driver.kind == "requests":
        lat = np.sort(w.latencies_s)
        log(f"[{name}] requests: p50 {lat[len(lat) // 2] * 1e3:.4f} ms, "
            f"p99 {lat[min(len(lat) - 1, int(0.99 * len(lat)))] * 1e3:.4f}"
            f" ms, launches {json.dumps(w.launches)}")
    log(f"[{name}] window: {w.completed} of {w.attempted} decisions in "
        f"{w.seconds:.6f} s (calls {[round(x, 4) for x in w.call_s]}, "
        f"traced {w.trace and round(w.trace['wall_s'], 4)} s); plans "
        f"{json.dumps(system.plans())}; last call's chunk modes "
        f"{json.dumps(system.modes())}")

    # Read back part of the state, then free the program's state before
    # the reference runs.
    peek_ids = driver.peek_keys(check.peek_keys(
        np.random.default_rng([entropy, 1]), driver.num_keys,
        traffic["peek"]))
    peek_stamp = clock.set(driver.last_stamp() + check.PEEK_AFTER_MS)
    peeks = np.asarray(driver.peek(peek_ids))
    algo, chips = config["algorithm"], len(system.devices) or 1
    system.close()
    del system

    t_check = time.perf_counter()
    numbers = check.replay(config, driver.replay(), peek_ids, peek_stamp,
                           peeks)
    numbers["unanswered"] = int(w.failed)
    log(f"[{name}] reference: {numbers['decisions']} decisions and "
        f"{numbers['peeks']} read backs in "
        f"{time.perf_counter() - t_check:.3f} s")

    run = SimpleNamespace(kind=driver.kind, algo=algo, chips=chips,
                          setup_s=marks["setup_s"], window=w,
                          memory_peak_bytes=int(peak))
    metrics = {}
    for m in (cell["per_layer"] if traced else cell["end_to_end"]):
        value = spec.reader(m["name"])(run)
        if value is None:
            log(f"[{name}] {m['name']}: nothing to read")
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device is None else str(device),
           "kind": device_kind(device), "count": chips,
           "memory_peak_bytes": int(peak)}
    result = {"correct": check.verdict(numbers),
              "attempted": int(w.attempted), "failed": int(w.failed),
              "metrics": metrics, "device": dev}
    if traced and w.trace is not None:
        busy = sum(w.trace["busy_us"].values()) / 1e6 / chips
        dev["busy_s"] = busy
        dev["window_s"] = w.trace["window_us"] / 1e6
        result["breakdown"] = {"device_ops": w.trace["device_ops"],
                               "idle_gaps": w.trace["idle_gaps"]}
    result["checks"] = {k: {"value": numbers[k], "limit": lim}
                        for k, lim in check.LIMITS.items()}
    return result


class HostMeter:
    """What the host did over the window, for the log: the process's CPU
    seconds (``getrusage``) and the garbage collector's passes and
    seconds."""

    def __init__(self):
        self.gc_s, self.gc_passes, self._t = 0.0, 0, None
        gc.callbacks.append(self._on_gc)
        self.ru = resource.getrusage(resource.RUSAGE_SELF)

    def _on_gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.gc_s += time.perf_counter() - self._t
            self.gc_passes += 1
            self._t = None

    def read(self) -> dict:
        gc.callbacks.remove(self._on_gc)
        ru = resource.getrusage(resource.RUSAGE_SELF)
        return {"user_s": round(ru.ru_utime - self.ru.ru_utime, 3),
                "sys_s": round(ru.ru_stime - self.ru.ru_stime, 3),
                "gc_passes": self.gc_passes, "gc_s": round(self.gc_s, 4)}


def device_kind(device) -> str:
    import torch
    if device is None:
        return torch.cuda.get_device_name(0)
    return str(device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        cell = spec.load_cell(args.workload)
    except KeyError as exc:
        log(f"error: {exc}")
        return 2
    chips = int(cell["workload"]["chips"])
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"error: the cell needs {chips} CUDA device(s); "
            f"torch.cuda.is_available()={torch.cuda.is_available()}, "
            f"device_count={torch.cuda.device_count()}")
        return 1
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    loaded = forbidden_modules()
    if loaded:
        log(f"error: the process loaded {', '.join(loaded)}")
        return 3
    for k, v in result["checks"].items():
        log(f"check {k} {v['value']} limit {v['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
