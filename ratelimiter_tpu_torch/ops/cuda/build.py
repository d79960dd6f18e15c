"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``.cu`` file in this directory with a plain C entry
point.  On first use it is compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into a shared library under
``build/kernels/`` at the repository root, named by a hash of the source
and the flags (an edited source rebuilds; an unchanged one loads the
existing library), and loaded with ``ctypes``.  No PyTorch headers are
compiled, so a build takes seconds.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

import torch

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parents[2] / "build" / "kernels"
KERNELS = ("solver", "block_scatter", "relay_step")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default
    install location."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit on the machine that has the card")


def library_path(name: str) -> Path:
    """Where the library for kernel ``name`` is built: keyed by a hash of
    its source and the compiler flags."""
    digest = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def nvcc_command(name: str, out: Path) -> list:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out),
            str(SRC_DIR / f"{name}.cu")]


def build(names: Iterable[str] = KERNELS) -> None:
    """Compile every library in ``names`` that is not built yet: one
    ``nvcc`` per source, all started together.  Raises with the
    compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(nvcc_command(name, tmp),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, proc))
    errors = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{name}.cu: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))


def require(t, name: str, dtype, ndim: int, device=None) -> None:
    """Raise ValueError unless ``t`` is a contiguous CUDA tensor of
    ``dtype`` and rank ``ndim`` (on ``device`` when given) — the only
    tensors the kernels take."""
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got "
                         f"{getattr(t, 'device', type(t))}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name}: expected {dtype} of rank {ndim}, got "
                         f"{t.dtype} of shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib
