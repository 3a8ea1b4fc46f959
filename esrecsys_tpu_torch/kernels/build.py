"""Build the package's CUDA sources into shared libraries loaded with ctypes.

Each ``csrc/<name>.cu`` compiles, at its first use in a process, with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
into ``_build/lib<name>-<hash>.so`` beside the package, where ``<hash>``
covers the source and the flags, so an edited source never loads a stale
library. A plain C interface keeps the build to seconds; a source that
includes PyTorch's headers takes minutes. The compiler's output (register
and shared-memory use, from ``-Xptxas -v``) is kept in ``build_logs``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# compiler output and build time, by source name
build_logs: Dict[str, str] = {}
build_seconds: Dict[str, float] = {}


def find_nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or the
    toolkit's default location. Raises when there is none."""
    cands = [os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
             shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "host with the CUDA toolkit")


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``."""
    with _lock:
        if name in _libs:
            return _libs[name]
        src = CSRC_DIR / f"{name}.cu"
        digest = hashlib.sha256(src.read_bytes()
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()
        out = BUILD_DIR / f"lib{name}-{digest[:16]}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                capture_output=True, text=True)
            build_seconds[name] = time.perf_counter() - t0
            build_logs[name] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {src} (exit {proc.returncode}):\n"
                    f"{build_logs[name]}")
            os.replace(tmp, out)  # atomic publish
        lib = ctypes.CDLL(str(out))
        _libs[name] = lib
        return lib
