#!/usr/bin/env python3
"""The control of a cell's comparison: the reference put in the
program's place with one of the configuration's guarantees broken.

    python3 benchmark/control.py --workload <cell> --seed <n> \
        --calls <window calls> --call-ms <ms a call> [--requests <n>]

The control takes the cell's own traffic, drawn from the seed by the
cell's driver as a run draws it (``Driver.planned``: fill, plan-settling
calls, then the window's calls stamped ``--call-ms`` apart, or for a
request cell ``--requests`` requests a thread).  The reference decides it
soundly; those decisions and read backs then stand where the program's
would, and ``lib/check.py:replay`` decides the traffic again with lost
updates (``benchmark/reference``: every request of a call reads the state
as the call found it, and one write to a key wins) and compares, as a run
compares the program.  It prints one JSON line with the numbers compared
and ``correct``, the verdict of ``lib/check.py``, which has to come out
false.  The benchmark's own runs never run this; it needs no card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from benchmark import reference  # noqa: E402
from benchmark.lib import check, spec  # noqa: E402
from benchmark.lib.clock import RecordedClock  # noqa: E402


def readings(cell: dict, seed: int, calls: int, call_ms: int,
             requests: int) -> dict:
    config, traffic = cell["config"], dict(cell["traffic"])
    if "requests_per_thread" in traffic:
        traffic["requests_per_thread"] = requests
    entropy = int(seed) % (1 << 64)
    driver = spec.driver(traffic["driver"])(
        None, config, traffic, np.random.default_rng(entropy),
        RecordedClock())
    planned = driver.planned(calls, call_ms)
    sound = reference.make(config["reference"], config["limiter"],
                           driver.num_keys)
    groups, decided = {}, []
    for key, ids, stamp, extra in planned:
        g = groups.get(key) if key is not None else None
        if g is None:
            g = reference.group(ids)
            if key is not None:
                groups[key] = g
        decided.append((key, ids, stamp, sound.call(g, int(stamp), **extra),
                        extra))
    peek_ids = driver.peek_keys(check.peek_keys(
        np.random.default_rng([entropy, 1]), driver.num_keys,
        traffic["peek"]))
    stamp = int(planned[-1][2]) + check.PEEK_AFTER_MS
    numbers = check.replay(config, decided, peek_ids, stamp,
                           sound.available(peek_ids, stamp),
                           lost_updates=True)
    # The reference in the program's place answers every request.
    numbers["unanswered"] = 0
    return {"workload": cell["workload"]["name"], "seed": seed,
            "correct": check.verdict(numbers), **numbers}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--calls", type=int, default=20)
    p.add_argument("--call-ms", type=int, default=1000)
    p.add_argument("--requests", type=int, default=1300)
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    print(json.dumps(readings(cell, args.seed, args.calls, args.call_ms,
                              args.requests)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
