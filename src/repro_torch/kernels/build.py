"""Build the CUDA C++ kernels under ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so nvcc
compiles it in seconds into ``_build/lib<name>-<hash>.so``, which ctypes
loads.  ``<hash>`` covers the source, the shared ``csrc/*.cuh`` headers and
the flags: an edited source builds anew, an unchanged one is loaded as it
is.  Sources build in parallel, one
nvcc process each.  ``_build/`` is listed in ``.gitignore``.

Entry points take every pointer and the CUDA stream as ``c_void_p`` and
return ``cudaGetLastError()``; the wrappers raise when it is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("fused_mlp", "grouped_mlp", "norm_codes", "qmatmul",
           "sparse_matmul", "ssd_scan")
# sm_90a: Hopper with its architecture-specific features.  No fast-math:
# the kernels' numerics depend on IEEE division and unfused mul/add.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels are "
            "compiled at first use and need the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` lives for its current hash."""
    digest = hashlib.sha256()
    digest.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source whose build is missing or stale, all in
    parallel.  Returns ``{name: ptxas report}`` for the sources it compiled
    (the per-kernel register and shared-memory use that ``-Xptxas -v``
    prints)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    try:
        for name in names:
            target = library_path(name)
            if target.exists():
                continue
            tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((name, target, tmp, proc))
        reports = {}
        for name, target, tmp, proc in jobs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
            os.replace(tmp, target)     # atomic: readers never see a partial .so
            reports[name] = log
        return reports
    finally:
        for _, _, _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library for ``csrc/<name>.cu``, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        return lib
