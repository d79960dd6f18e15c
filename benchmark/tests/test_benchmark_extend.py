"""A configuration with a reference of its own and a traffic mix with a
driver of its own are added as new files and new entries of
``BENCHMARK.json`` alone, in a copy of the benchmark (the program is
imported from the repository); a run of the new cell uses them and is
correct, and no file that was there changed."""

import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent

REFERENCE = '''"""A token bucket that counts its calls."""

from benchmark.reference.token_bucket import TokenBucket

CALLS = []


class Reference(TokenBucket):
    def call(self, g, now, lost_updates=False):
        CALLS.append(g.n)
        return super().call(g, now, lost_updates=lost_updates)
'''

DRIVER = '''"""Stream calls sent in pieces of ``piece_keys``."""

import numpy as np

from benchmark.lib import spec

Stream = spec.driver("stream")
PIECES = []


class Driver(Stream):
    def setup(self):
        super().setup()
        whole, n = self.entry, int(self.traffic["piece_keys"])

        def pieces(keys, permits, **kw):
            PIECES.append(len(keys))
            return np.concatenate([whole(keys[s:s + n], permits, **kw)
                                   for s in range(0, len(keys), n)])
        self.entry = pieces
'''


def digest(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): hashlib.sha256(
        p.read_bytes()).hexdigest()
        for p in sorted(root.rglob("*"))
        if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_config_and_mix_need_only_new_files(tmp_path):
    for name in ("BENCHMARK.json", "application.properties"):
        shutil.copy(ROOT / name, tmp_path)
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digest(tmp_path / "benchmark")
    b = tmp_path / "benchmark"
    config = json.loads((b / "configs" / "tb_1m_zipf.json").read_text())
    config.update(name="tb_counted", reference="counted_bucket")
    (b / "configs" / "tb_counted.json").write_text(json.dumps(config))
    (b / "reference" / "counted_bucket.py").write_text(REFERENCE)
    mix = json.loads((b / "traffic" / "stream_strs.json").read_text())
    mix.update(driver="pieces", piece_keys=5000)
    (b / "traffic" / "pieces_strs.json").write_text(json.dumps(mix))
    (b / "drivers" / "pieces.py").write_text(DRIVER)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    cell = "tb_counted.pieces_strs"
    bench["configs"].append(dict(bench["configs"][0], name="tb_counted",
                                 file="benchmark/configs/tb_counted.json"))
    bench["workloads"].append({"name": cell, "config": "tb_counted",
                               "traffic": "pieces_strs", "chips": 1,
                               "why": "a test cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(cell)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    code = (
        "import json, sys\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT)!r}]\n"
        "from benchmark.lib import spec\n"
        "from benchmark.tests.tiny import run_tiny\n"
        f"r = run_tiny({cell!r}, seconds=0.3)\n"
        "print(json.dumps({'correct': r['correct'], 'metrics': "
        "sorted(r['metrics']), 'pieces': len(spec.module('drivers', "
        "'pieces').PIECES), 'calls': len(spec.module('reference', "
        "'counted_bucket').CALLS), 'root': str(spec.ROOT)}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["root"] == str(tmp_path)
    assert got["correct"], out.stderr[-3000:]
    assert got["pieces"] > 0 and got["calls"] > 0
    # The cell's end-to-end metrics; the device memory reading needs a
    # card, so on the CPU only the set-up time is read.
    assert set(got["metrics"]) == {"setup_s"}
    after = digest(tmp_path / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before
