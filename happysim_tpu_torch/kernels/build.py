"""Building the port's CUDA sources into shared libraries.

Every source in :data:`SOURCES` is compiled on first use with ``nvcc``
into ``build/`` at the repository root (which .gitignore lists), one
library per source, all ``nvcc`` processes started together, and each
library is loaded with ``ctypes`` once per process. A library is rebuilt
only when its source, the shared headers or the flags change.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
# One library per source: the event-step kernel without telemetry or
# resilience, its telemetry instantiations, its resilience instantiations,
# its consensus instantiations, its instantiations for several sources or
# sinks (three codes by feature set), its trace-driven instantiations, its wide
# code, its partitioned instantiations, the standalone draw kernel, the
# M/M/1 ensemble's Lindley scan and the partitioned executor's window
# barrier.
SOURCES = (
    CSRC / "event_step.cu",
    CSRC / "event_step_telemetry.cu",
    CSRC / "event_step_resilience.cu",
    CSRC / "event_step_consensus.cu",
    CSRC / "event_step_multi.cu",
    CSRC / "event_step_trace.cu",
    CSRC / "event_step_wide.cu",
    CSRC / "event_step_partitioned.cu",
    CSRC / "uniform.cu",
    CSRC / "mm1_scan.cu",
    CSRC / "partition_barrier.cu",
)
HEADERS = (CSRC / "event_step.cuh", CSRC / "threefry.cuh", CSRC / "partition_barrier.cuh")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
# No --use_fast_math, and no multiply-add contraction: the kernels must
# round exactly as their plain versions' one-op-per-kernel torch code.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


def build_libraries() -> dict:
    """Compile each of :data:`SOURCES` into ``build/`` unless a library for
    these exact sources and flag set is already there, one ``nvcc`` per
    source, all started together. Returns ``{source stem: (library path,
    compiler log)}``, the log holding ``-Xptxas -v``'s registers and
    spills per kernel (empty for a library already built)."""
    header_bytes = b"".join(p.read_bytes() for p in HEADERS)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for source in SOURCES:
        digest = hashlib.sha256(
            source.read_bytes() + header_bytes + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        out = BUILD_DIR / f"{source.stem}_{digest}.so"
        if out.exists():
            jobs[source] = (out, None, None)
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
        )
        jobs[source] = (out, tmp, proc)
    built, failed = {}, []
    for source, (out, tmp, proc) in jobs.items():  # wait for every nvcc
        if proc is None:
            built[source.stem] = (out, "")
            continue
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed to build {source.name}:\n{stderr}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
        built[source.stem] = (out, stdout + stderr)
    if failed:
        raise RuntimeError("\n".join(failed))
    return built


def libraries() -> dict:
    """Build (first use) and load every library, once per process;
    returns ``{source stem: ctypes library}``."""
    if "libs" not in _loaded:
        _loaded["libs"] = {
            stem: ctypes.CDLL(str(path)) for stem, (path, _log) in build_libraries().items()
        }
    return _loaded["libs"]
