"""Build the port's CUDA sources and load them with ctypes.

Every ``paddle_tpu_torch/csrc/<name>.cu`` compiles on its own with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface
(no PyTorch headers, so a build takes seconds, not minutes), written to
``paddle_tpu_torch/_build/<name>-<hash>.so``. The hash covers the
source, every ``csrc/*.cuh`` header it includes and the flags, so an
edited kernel or header rebuilds and an unchanged one is reused.
Nothing builds at import time: the first wrapper call that needs a
library builds it, and :func:`build` builds several at once, one
``nvcc`` process per source, all started together.

There is no fallback: without ``nvcc``, or when a build fails, the
error is raised with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# -Xptxas -v writes registers, shared memory and spills per kernel into
# the build log (see build_log)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def sources() -> list[str]:
    """Names of every kernel source under csrc/."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the "
            "port's CUDA kernels are built from paddle_tpu_torch/csrc at "
            "first use and need the CUDA toolkit")
    return path


def headers(name: str) -> list[str]:
    """The csrc/ headers that csrc/<name>.cu includes (``#include "x.cuh"``),
    directly or through another header, in the order first met."""
    found, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        text = todo.pop(0).read_text()
        for h in re.findall(r'^\s*#\s*include\s+"([^"]+)"', text, re.M):
            if h not in found and (CSRC / h).exists():
                found.append(h)
                todo.append(CSRC / h)
    return found


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in headers(name):
        h.update(header.encode())
        h.update((CSRC / header).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, float]:
    """Compile the named sources (default: all) that are not built yet,
    one nvcc each, in parallel. Returns {name: build seconds} for the
    sources this call compiled."""
    names = sources() if names is None else list(names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    running = []
    for n in todo:
        so = library_path(n)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((n, proc, tmp, so, time.perf_counter()))
    seconds, failed = {}, []
    for n, proc, tmp, so, t0 in running:
        out, _ = proc.communicate()
        so.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for csrc/{n}.cu "
                          f"(exit {proc.returncode}):\n{out[-4000:]}")
            continue
        os.replace(tmp, so)   # atomic: a reader never sees half a file
        seconds[n] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def build_log(name: str) -> str:
    """The compiler output of the current build of ``name`` (ptxas
    register, shared-memory and spill report included)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise when a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch "
                           "(cudaGetLastError after the kernel launch)")
