"""Build and load the package's CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ctypes. Builds happen at
first use, from the sources in the checkout, into ``build/kernels/`` at the
repository root (listed in ``.gitignore``). A library's file name carries a
hash of its source and of every header it includes from ``csrc/``
(``#include "..."``, followed recursively), so an edited source or header
is rebuilt and an unchanged one is reused. ``build_all`` starts one
``nvcc`` per source at once and waits for all of them.

Nothing here runs at import time: the CPU test suite imports every module
of the package on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
SOURCES = {"fwd_pairwalk": "fwd_pairwalk.cu",
           "bwd_pairwalk": "bwd_pairwalk.cu",
           "seg_reduce": "seg_reduce.cu",
           "pnp_refine": "pnp_refine.cu"}
_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)
# no --use_fast_math: __expf would move alpha away from the reference
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


@dataclasses.dataclass(frozen=True)
class Built:
    name: str
    path: Path
    seconds: float     # nvcc wall time; 0.0 when the library was reused
    log: str           # nvcc/ptxas output (registers, shared memory, spills)


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _source_files(name: str) -> list[Path]:
    """The source of kernel ``name`` and every ``csrc/`` header it includes
    with quotes, directly or through another header, in a fixed order."""
    files, todo = [], [CSRC / SOURCES[name]]
    while todo:
        path = todo.pop(0)
        if path in files:
            continue
        files.append(path)
        for inc in _LOCAL_INCLUDE.findall(path.read_text()):
            todo.append((path.parent / inc).resolve())
    return files


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _source_files(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict[str, Built]:
    """Build the named kernels (default: all), one ``nvcc`` each, started
    together. Raises with the compiler's output if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: dict[str, Built] = {}
    running = {}
    for name in names:
        path = _lib_path(name)
        if path.exists():
            out[name] = Built(name, path, 0.0, "reused")
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, path, tmp, time.perf_counter())
    failed = []
    for name, (proc, path, tmp, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, path)
        out[name] = Built(name, path, seconds, log)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


_LOADED: dict[str, ctypes.CDLL] = {}


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use and loaded once per
    process."""
    if name not in _LOADED:
        built = build_all([name])[name]
        _LOADED[name] = ctypes.CDLL(str(built.path))
    return _LOADED[name]
