"""Build and load the port's CUDA kernels.

Each source under ``ops/csrc/`` is compiled by ``nvcc`` into a shared
library with a plain C interface and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds, not minutes).  Libraries go to
``build/torch_kernels/`` beside the package, named by a hash of the source
and the flags, so an edited source is rebuilt and an unchanged one is
loaded as it is.  Nothing is built when a module is imported: the first
launch builds, or a caller builds all sources up front with
:func:`build_all`, which starts one ``nvcc`` per source at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from functools import lru_cache
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
# library: (source, the csrc/ headers it includes)
SOURCES = {"stencil": (CSRC / "stencil.cu",
                       ("stencil_tile.cuh", "vcycle.cuh")),
           "stencil_sym": (CSRC / "stencil_sym.cu",
                           ("stencil_sym.cuh", "stencil_tile.cuh")),
           "stencil_sym_blocked": (CSRC / "stencil_sym_blocked.cu",
                                   ("stencil_sym.cuh", "stencil_tile.cuh"))}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """``nvcc`` from ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, then PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found in $CUDA_HOME/bin, /usr/local/cuda/bin "
                       "or PATH; the port's CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """The library of ``name``, keyed by its source, the headers it
    includes and the flags."""
    source, headers = SOURCES[name]
    src = source.read_bytes() + b"".join(
        (CSRC / h).read_bytes() for h in headers)
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}.so"


def build_all(names=None) -> dict:
    """Compile every named source (default: all) that is not built yet, one
    ``nvcc`` process per source, all started together.  Returns
    ``{name: {"seconds": s, "cached": bool, "log": nvcc output}}`` and
    raises RuntimeError naming every source that failed to build."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    running = {}
    report = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            report[name] = {"seconds": 0.0, "cached": True, "log": ""}
            continue
        nvcc = nvcc or find_nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name][0])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half
        report[name] = {"seconds": seconds, "cached": False, "log": log}
    if failed:
        raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    return report


@lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build ``name`` if needed and load it (once per process)."""
    build_all([name])
    return ctypes.CDLL(str(library_path(name)))
