"""Builds ``csrc/<name>.cu`` with nvcc (``csrc/<name>.cpp``, host code, with
g++) and loads the result with ctypes.

Each source has a plain C interface: pointers, sizes and the CUDA stream come
in as integers, and every CUDA entry point returns ``cudaGetLastError()``
after its launch, which :func:`check` turns into an exception. Libraries go
to ``build/torch_kernels/`` at the checkout's root and are rebuilt when their
source is newer. Nothing here runs at import time: the CPU tests import every
module of the package on machines that have no nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
GXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-shared"]

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return found


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def source_path(name: str) -> Path:
    """``csrc/<name>.cu``, else ``csrc/<name>.cpp``."""
    cu = CSRC_DIR / f"{name}.cu"
    return cu if cu.exists() else CSRC_DIR / f"{name}.cpp"


def _stale(name: str) -> bool:
    lib = library_path(name)
    return not lib.exists() or lib.stat().st_mtime < source_path(name).stat().st_mtime


def _start(name: str) -> tuple[subprocess.Popen, Path]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"
    src = source_path(name)
    compiler = [nvcc(), *NVCC_FLAGS] if src.suffix == ".cu" else ["g++", *GXX_FLAGS]
    cmd = [*compiler, "-o", str(tmp), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp


def _finish(name: str, proc: subprocess.Popen, tmp: Path) -> str:
    log, _ = proc.communicate()
    (BUILD_DIR / f"{name}.log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"compiling {source_path(name).name} failed (exit {proc.returncode}):\n{log}")
    tmp.replace(library_path(name))
    return log


def build(*names: str) -> dict[str, str]:
    """Compile the named sources that are stale, one compiler process each,
    all started together. Returns each compiler log (for CUDA sources, ptxas
    register and shared-memory use), empty for a library that was already
    current."""
    with _lock:
        jobs = {n: _start(n) for n in names if _stale(n)}
        return {n: _finish(n, *jobs[n]) if n in jobs else "" for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build(name)
        with _lock:
            lib = _loaded.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(library_path(name)))
                lib.kernel_error_string.argtypes = [ctypes.c_int]
                lib.kernel_error_string.restype = ctypes.c_char_p
                _loaded[name] = lib
    return lib


@functools.cache
def function(library: str, symbol: str, argtypes: tuple, restype=ctypes.c_int):
    """A kernel's C entry point in ``csrc/<library>``, bound once: its
    argument and result types (an error code unless ``restype`` says
    otherwise) are set on the first call for it and the function object is
    cached, so a launch pays only for the call itself (``fn.lib``: its
    library, for :func:`check`)."""
    lib = load(library)
    fn = getattr(lib, symbol)
    fn.argtypes, fn.restype, fn.lib = list(argtypes), restype, lib
    return fn


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
