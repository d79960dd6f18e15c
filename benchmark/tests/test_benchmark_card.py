"""On the card: a short run of each cell through the command the
benchmark's check runs, whose result is correct.  Skips without a card
(run with ``python -m pytest benchmark/tests -m card`` on the machine
that has one)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.card
@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_a_short_run_on_the_card_is_correct(card, cell):
    if card < cell["chips"]:
        pytest.skip(f"{cell['name']} needs {cell['chips']} cards")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell["name"],
         "--seed", "6000000001", "--seconds", "3", "--trace", "1"],
        capture_output=True, text=True, cwd=ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["busy_s"] > 0
