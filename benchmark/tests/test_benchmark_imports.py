"""Nothing of the benchmark imports JAX or the JAX package, and nothing
reads the JAX package's drivers; the port's name begins with the JAX
package's, so names are compared whole, by their top-level part."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "ratelimiter_tpu"}
SOURCES = sorted(HERE.rglob("*.py"))


def imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(HERE)))
def test_no_jax_import(path):
    assert not imported(path) & FORBIDDEN


def test_the_port_is_not_mistaken_for_the_jax_package():
    src = "import ratelimiter_tpu_torch.service\nimport numpy\n"
    tree = ast.parse(src)
    names = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    assert names == {"ratelimiter_tpu_torch", "numpy"}
    assert not names & FORBIDDEN


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(HERE)))
def test_no_jax_driver_read(path):
    text = path.read_text()
    # The needles are built here so that this file does not hold them.
    for q in "\"'":
        for needle in (q + "bench" + ".py" + q, q + "bench" + "/"):
            assert needle not in text
    for needle in ("BENCH" + "_r0", "MULTICHIP" + "_r0"):
        assert needle not in text


def test_a_run_loads_no_jax():
    """A whole run on the CPU, in a fresh interpreter: afterwards no
    module of JAX or of the JAX package is loaded."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from benchmark.tests.tiny import run_tiny\n"
        "from benchmark import run\n"
        "r = run_tiny('sw_10m_uniform.stream_ids', seconds=0.3)\n"
        "assert r['correct'], r\n"
        "print('LOADED', run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout


def test_no_card_no_result():
    """Without a card the command exits non-zero and prints no result."""
    out = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload",
         "tb_1m_zipf.stream_strs", "--seed", "5000000001", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    """In a directory that holds only ``BENCHMARK.json`` and the
    benchmark's files the command exits non-zero and prints no
    result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "sw_10m_uniform.stream_ids", "--seed", "5000000002", "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=tmp_path, env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
