"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each source in `csrc/` is compiled on first use by its own `nvcc` process
(all started together) for sm_90a into `gtsam_petercdev_torch/_build/`, then
loaded with ctypes. The library's file name carries a hash of its source and
flags, so an edited source is rebuilt and a stale library is never loaded.
Only the sources in this repository are compiled.

The C entry points take every pointer and the stream as `void*` and return
`cudaGetLastError()` after the launch; the wrappers raise if it is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# kernel library name -> source file in csrc/
SOURCES = {
    "partial_cholesky": "partial_cholesky.cu",
    "backsolve": "backsolve.cu",
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
# argtypes of the C entry points (T = the kernel's float type)
_SIGNATURES = {
    # F, g, scratch, L, Linv, W, y, U, ug, bad, B, nf, ns, d, eps, stream
    "partial_cholesky": lambda T: [_P] * 10 + [_I] * 4 + [T, _P],
    # L, Linv, W, y, xs, x, B, nf, ns, d, stream
    "backsolve": lambda T: [_P] * 6 + [_I] * 4 + [_P],
}

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return path


def library_path(name: str) -> str:
    with open(os.path.join(CSRC, SOURCES[name]), "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{h}.so")


def build_all(verbose: bool = False) -> List[str]:
    """Compile every kernel library that is not built yet, one nvcc per
    source, all in parallel. verbose: add `-Xptxas=-v` and return nvcc's
    register / shared-memory / spill report lines."""
    nvcc = nvcc_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name, src in SOURCES.items():
        out = library_path(name)
        if os.path.exists(out) and not verbose:
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc] + NVCC_FLAGS + (["-Xptxas=-v"] if verbose else [])
        cmd += ["-o", tmp, os.path.join(CSRC, src)]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        )))
    report, failed = [], []
    for name, out, tmp, p in procs:
        stdout, stderr = p.communicate()
        if p.returncode != 0:
            failed.append(f"{name}: nvcc exit {p.returncode}\n{stderr}")
            os.unlink(tmp)
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees old or new
        report.extend(f"[{name}] {ln}" for ln in (stdout + stderr).splitlines() if ln.strip())
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built on first use; argtypes declared."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            if not os.path.exists(library_path(name)):
                build_all()
            lib = ctypes.CDLL(library_path(name))
            for suffix, T in (("f32", ctypes.c_float), ("f64", ctypes.c_double)):
                fn = getattr(lib, f"gtsam_{name}_{suffix}")
                fn.argtypes = _SIGNATURES[name](T)
                fn.restype = ctypes.c_int
            _LOADED[name] = lib
        return lib
