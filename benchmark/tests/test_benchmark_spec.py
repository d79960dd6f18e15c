"""``BENCHMARK.json`` keeps to the benchmark's contract: its keys, names,
units, lengths and bounds, and every file and reader it names."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = [w["name"] for w in BENCH["workloads"]]


def one_line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(one_line(w) for w in cmd)
    assert (ROOT / cmd[1]).is_file()
    assert any(cmd[1].startswith(p + "/") for p in BENCH["paths"])


def test_run_seconds_fits_the_full_check():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    cells = 24
    assert (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200 <= 43200


def test_names_are_unique_and_well_formed():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    assert len(CELLS) == len(set(CELLS))
    configs = [c["name"] for c in BENCH["configs"]]
    assert len(configs) == len(set(configs))


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric(metric):
    keys = {"name", "unit", "better", "source"}
    if metric in BENCH["end_to_end"]:
        keys |= {"bound"}
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        keys |= {"layer", "moves"}
        assert one_line(metric["layer"])
        e2e = {m["name"]: m for m in BENCH["end_to_end"]}
        assert metric["moves"] in e2e
        moved = e2e[metric["moves"]]
        for cell in metric.get("workloads", CELLS):
            assert cell in moved.get("workloads", CELLS)
    assert set(metric) - {"workloads"} == keys
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    for cell in metric.get("workloads", []):
        assert cell in CELLS
    assert (ROOT / "benchmark" / "metrics" / f"{metric['name']}.py").is_file()
    if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_setup_s_is_reported_everywhere():
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert "workloads" not in setup and setup["bound"] <= 0.25


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert one_line(config["source"]) and one_line(config["why"])
    assert config["source"].startswith("https://")
    assert any(config["file"].startswith(p + "/") for p in BENCH["paths"])
    data = json.loads((ROOT / config["file"]).read_text())
    assert data["name"] == config["name"]
    assert data["reduced"] == config["reduced"]
    assert len(config["reduced"]) <= 16
    for key in ("source", "guarantees", "slots", "assumed", "algorithm",
                "limiter_class", "reference", "limiter", "keys", "chips"):
        assert key in data
    assert (ROOT / "benchmark" / "reference" /
            f"{data['reference']}.py").is_file()
    assert data["limiter_class"].split(".")[0] == "ratelimiter_tpu_torch"
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


def test_config_files_are_distinct():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4) and one_line(cell["why"])
    assert NAME.match(cell["traffic"]) and NAME.match(cell["config"])
    config = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
    data = json.loads((ROOT / config["file"]).read_text())
    assert data["chips"] == cell["chips"]
    traffic = json.loads((ROOT / "benchmark" / "traffic" /
                          f"{cell['traffic']}.json").read_text())
    assert (ROOT / "benchmark" / "drivers" /
            f"{traffic['driver']}.py").is_file()
    reported = [m for m in BENCH["end_to_end"]
                if cell["name"] in m.get("workloads", CELLS)]
    assert any(m["name"] == "setup_s" for m in reported)
    assert len(reported) >= 2
    assert any(cell["name"] in m.get("workloads", CELLS)
               for m in BENCH["per_layer"])


def test_pairs_and_four_chip_share():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)
    assert 1 <= len(CELLS) <= 24 and 1 <= len(BENCH["configs"]) <= 24


def test_benchmark_files_are_named_from_name_characters():
    for path in (ROOT / "benchmark").rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert PATH.match(rel), rel
