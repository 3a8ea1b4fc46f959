"""Build the package's CUDA sources into shared libraries loaded with ctypes.

Each ``csrc/<name>.cu`` compiles, at its first use in a process, with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
into ``_build/lib<name>-<hash>.so`` beside the package, where ``<hash>``
covers the source and the flags, so an edited source never loads a stale
library. A plain C interface keeps the build to seconds; a source that
includes PyTorch's headers takes minutes. :func:`build_all` starts one
``nvcc`` per source at once and waits for all of them. The compiler's
output (register and shared-memory use, from ``-Xptxas -v``) is kept in
``build_logs``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# compiler output, by source name
build_logs: Dict[str, str] = {}


class LaunchCounter:
    """Launches of one kernel: ``count`` grows by one per launch, and
    ``by_instantiation`` counts them by the name the wrapper gives
    (:meth:`add`)."""

    def __init__(self) -> None:
        self.count = 0
        self.by_instantiation: Dict[str, int] = {}

    def add(self, instantiation: str) -> None:
        self.count += 1
        self.by_instantiation[instantiation] = (
            self.by_instantiation.get(instantiation, 0) + 1)

    def reset(self) -> None:
        self.count = 0
        self.by_instantiation = {}


def kernel_sources() -> List[str]:
    """Names of every CUDA source of the package (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


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


def _target(name: str) -> Tuple[Path, Path]:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return src, BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all(names: Iterable[str]) -> None:
    """Compile every named source that has no current library, all
    ``nvcc`` processes at once, then load them. Raises on the first
    failed build, after every compiler has exited."""
    with _lock:
        jobs = []
        for name in names:
            if name in _libs:
                continue
            src, out = _target(name)
            if not out.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                proc = subprocess.Popen(
                    [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
                jobs.append((name, src, out, tmp, proc))
            else:
                jobs.append((name, src, out, None, None))
        failed = []
        for name, src, out, tmp, proc in jobs:
            if proc is None:
                continue
            log_text, _ = proc.communicate()
            build_logs[name] = log_text
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {src} (exit "
                              f"{proc.returncode}):\n{log_text}")
            else:
                os.replace(tmp, out)  # atomic publish
        if failed:
            raise RuntimeError("\n".join(failed))
        for name, _, out, _, _ in jobs:
            _libs[name] = ctypes.CDLL(str(out))


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``."""
    build_all([name])
    return _libs[name]
