"""A cell of ``BENCHMARK.json`` and the files it names.

A cell (an entry of ``workloads``) pairs a configuration, whose file
``configs`` names, with a traffic mix, ``traffic/<traffic>.json``.  A
metric applies to a cell that its ``workloads`` lists, or, without that
key, to every cell.  Code is found by name, each piece in a file of its
own: a metric's reader in ``metrics/<name>.py``, a traffic mix's driver
in ``drivers/<driver>.py`` (the mix's ``"driver"``), a configuration's
reference in ``reference/<reference>.py`` (the configuration's
``"reference"``).
"""

from __future__ import annotations

import functools
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "benchmark"


def load_benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def metric_applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: dict | None = None) -> dict:
    """``{"workload", "config", "traffic", "end_to_end", "per_layer"}``
    for the cell ``name``; KeyError if the benchmark has none such."""
    bench = bench or load_benchmark()
    workload = next((w for w in bench["workloads"] if w["name"] == name),
                    None)
    if workload is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"]
                 if c["name"] == workload["config"])
    return assemble(workload, entry["file"], bench)


def assemble(workload: dict, config_file: str, bench: dict) -> dict:
    """The cell of ``workload`` (an entry as ``workloads`` holds one) over
    the configuration in ``config_file``."""
    name = workload["name"]
    config = json.loads((ROOT / config_file).read_text())
    traffic = json.loads(
        (HERE / "traffic" / f"{workload['traffic']}.json").read_text())
    return {
        "workload": workload,
        "config": config,
        "traffic": traffic,
        "end_to_end": [m for m in bench["end_to_end"]
                       if metric_applies(m, name)],
        "per_layer": [m for m in bench["per_layer"]
                      if metric_applies(m, name)],
    }


@functools.lru_cache(maxsize=None)
def module(folder: str, name: str):
    """The module of ``<folder>/<name>.py`` under the benchmark's folder,
    loaded once; KeyError if there is no such file."""
    path = HERE / folder / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {folder}/{name}.py in the benchmark")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{folder}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric_name: str):
    """The ``read(run)`` function of ``metrics/<metric_name>.py``."""
    return module("metrics", metric_name).read


def driver(name: str):
    """The ``Driver`` class of ``drivers/<name>.py``."""
    return module("drivers", name).Driver


def reference(name: str):
    """The ``Reference`` class of ``reference/<name>.py``."""
    return module("reference", name).Reference
