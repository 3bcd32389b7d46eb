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
    "partial_cholesky_smem": "partial_cholesky_smem.cu",
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
# library -> {C entry point (before its _f32 / _f64 suffix): argtypes, given
# T = the kernel's float type}
# F, g, L, Linv, W, y, U, ug, bad, B, nf, ns, d, eps, stream
_SMEM_SIGNATURE = lambda T: [_P] * 9 + [_I] * 4 + [T, _P]
_SIGNATURES = {
    # F, g, scratch, L, Linv, W, y, U, ug, bad, B, nf, ns, d, eps, stream
    "partial_cholesky": {"gtsam_partial_cholesky": lambda T: [_P] * 10 + [_I] * 4 + [T, _P]},
    # L, Linv, W, y, xs, x, B, nf, ns, d, stream
    "backsolve": {"gtsam_backsolve": lambda T: [_P] * 6 + [_I] * 4 + [_P]},
    "partial_cholesky_smem": {
        "gtsam_partial_cholesky_smem": _SMEM_SIGNATURE,
        "gtsam_partial_cholesky_blocks": _SMEM_SIGNATURE,
    },
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


def declare(lib: ctypes.CDLL, name: str) -> ctypes.CDLL:
    """Set argtypes / restype of every entry point of kernel library `name`."""
    for entry, signature in _SIGNATURES[name].items():
        for suffix, T in (("f32", ctypes.c_float), ("f64", ctypes.c_double)):
            fn = getattr(lib, f"{entry}_{suffix}")
            fn.argtypes = signature(T)
            fn.restype = ctypes.c_int
    return lib


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built on first use; argtypes declared."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            if not os.path.exists(library_path(name)):
                build_all()
            lib = _LOADED[name] = declare(ctypes.CDLL(library_path(name)), name)
        return lib
