"""Build and load the port's CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C interface, compiled
by ``nvcc`` for ``sm_90a`` into a shared library under
``ray_tpu_torch/_build/`` (listed in ``.gitignore``) and loaded with
``ctypes``.  A library's file name carries the hash of its source and of
the headers the sources share (``csrc/*.cuh``), so an edited source or
header is rebuilt and an unchanged one is reused.  Nothing is
built at import: ``load`` builds on first use, and ``build`` compiles
several kernels at once, one ``nvcc`` process per source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Iterable, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

# kernel name -> source file under csrc/
SOURCES = {"flash_fwd": "flash_fwd.cu", "flash_bwd": "flash_bwd.cu"}

_loaded: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                       "kernels are built from source on the GPU machine")


def _target(name: str) -> tuple:
    """(source path, library path) of kernel ``name``.  The library's name
    hashes the source and every header under ``csrc/`` (``*.cuh``, shared
    by the sources), so an edit to either rebuilds it."""
    src = os.path.join(CSRC, SOURCES[name])
    h = hashlib.sha256()
    for path in [src] + sorted(
            os.path.join(CSRC, f) for f in os.listdir(CSRC)
            if f.endswith(".cuh")):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return src, os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names: Optional[Iterable[str]] = None) -> dict:
    """Compile the named kernels (all by default) that are not built yet,
    every ``nvcc`` started at once.  Returns ``{name: (seconds, log)}``
    for the ones compiled here; ``log`` holds ptxas's register and
    shared-memory report, also kept beside the library for
    ``build_log``.  Raises with the compiler's output on failure."""
    names = list(names or SOURCES)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        src, lib = _target(name)
        if os.path.exists(lib):
            continue
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp, src]
        procs[name] = (time.perf_counter(), tmp, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    out = {}
    for name, (t0, tmp, lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {SOURCES[name]} "
                               f"(exit {proc.returncode}):\n{log}")
        with open(f"{lib}.log", "w") as f:
            f.write(log)
        os.replace(tmp, lib)      # atomic: a reader never sees half a file
        out[name] = (time.perf_counter() - t0, log)
    return out


def build_log(name: str) -> str:
    """The compiler's output (ptxas's report) from the build of kernel
    ``name``'s current source; builds it first if needed."""
    build([name])
    with open(f"{_target(name)[1]}.log") as f:
        return f.read()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = _loaded[name] = ctypes.CDLL(_target(name)[1])
    return lib
