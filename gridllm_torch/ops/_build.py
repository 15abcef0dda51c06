"""Build and load the CUDA kernels of gridllm_torch/csrc/.

Each `.cu` source compiles with `nvcc` alone into its own shared library
with a plain C interface (no PyTorch headers: seconds, not minutes), loaded
with ctypes. Libraries land in `build/` at the repository root, named by a
hash of the sources, headers and flags, so an unchanged tree never
rebuilds. `build_all()` starts one nvcc per source at once and waits for
all of them. Nothing here runs at import time.
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

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
SOURCES = ("paged_write.cu", "flash_prefill.cu", "ragged_attention.cu",
           "per_phase_attention.cu")
# --split-compile=0: each source's device optimisation on every core (the
# two attention sources, with their D = 256 instantiations, took 222 s
# each without it on the card's 8 cores; ragged_attention.cu alone ~100 s
# with it)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
              "--split-compile=0")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _lib_path(source: str) -> Path:
    h = hashlib.sha256()
    for path in [CSRC / source, *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build_all(sources: tuple[str, ...] = SOURCES) -> dict[str, dict]:
    """Compile every source whose library is missing, all nvcc processes
    at once. Returns {source: {"seconds", "cached", "ptxas"}}; raises
    RuntimeError with the compiler output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc() if any(not _lib_path(s).is_file() for s in sources) else ""
    procs: dict[str, tuple[subprocess.Popen, Path, Path, float]] = {}
    report: dict[str, dict] = {}
    for src in sources:
        out = _lib_path(src)
        if out.is_file():
            report[src] = {"seconds": 0.0, "cached": True, "ptxas": ""}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), tmp, out, time.perf_counter())
    failed = []
    for src, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{src}:\n{log}")
            continue
        os.replace(tmp, out)
        report[src] = {"seconds": secs, "cached": False, "ptxas": log}
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return report


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            path = _lib_path(source)
            if not path.is_file():
                build_all((source,))
            lib = ctypes.CDLL(str(path))
            _libs[source] = lib
        return lib
