"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each source in `csrc/` is compiled on first use by its own `nvcc` process
(all started together) for sm_90a into `gtsam_petercdev_torch/_build/`, then
loaded with ctypes. The library's file name carries a hash of its source, the
headers in `HEADERS` and the flags, so an edited source or header is rebuilt
and a stale library is never loaded.
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
    "schur_update": "schur_update.cu",
}
# device code the sources include (part of every library's hash)
HEADERS = ["factor_common.cuh"]

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
# library -> {C entry point (before its _f32 / _f64 suffix): argtypes, given
# T = the kernel's float type}
_SIGNATURES = {
    "partial_cholesky": {
        # F, scratch, L, Linv, bad, B, nf, m, d, eps, packed, threads, smem, stream
        "gtsam_k1_factor": lambda T: [_P] * 5 + [_I] * 4 + [T] + [_I] * 3 + [_P],
        # F, g, L, Linv, W, y, B, nf, m, d, slabs, staged, smem, stream
        "gtsam_k1_solve": lambda T: [_P] * 6 + [_I] * 7 + [_P],
    },
    # L, Linv, W, y, xs, x, B, nf, ns, d, warp_mode, grid, threads, cluster, rows,
    # stages, smem, stream
    "backsolve": {"gtsam_backsolve": lambda T: [_P] * 6 + [_I] * 11 + [_P]},
    "partial_cholesky_smem": {
        # F, g, L, Linv, W, y, bad, B, nf, ns, d, eps, stream
        "gtsam_partial_cholesky_smem": lambda T: [_P] * 7 + [_I] * 4 + [T, _P],
        # F, g, L, Linv, W, y, U, ug, bad, B, nf, ns, d, eps, G, threads, smem, stream
        "gtsam_partial_cholesky_blocks": lambda T: [_P] * 9 + [_I] * 4 + [T] + [_I] * 3 + [_P],
    },
    # F, g, W, y, U, ug, B, fd, sd, tiles, stream
    "schur_update": {"gtsam_schur_update": lambda T: [_P] * 6 + [_I] * 4 + [_P]},
}

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return path


def library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [SOURCES[name]] + HEADERS:
        with open(os.path.join(CSRC, src), "rb") as f:
            h.update(f.read())
    h = h.hexdigest()[:16]
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
