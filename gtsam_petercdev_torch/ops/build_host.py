"""Build and load the port's host libraries (g++ -> shared library -> ctypes).

Each source in `csrc/host/` is compiled on first use by its own `g++`
process (all started together) into `gtsam_petercdev_torch/_build/`, then
loaded with ctypes, as `ops/build.py` does for the CUDA kernels. The
library's file name carries a hash of its source and the flags, so an edited
source is rebuilt and a stale library is never loaded. A failed build
raises: nothing falls back to another route.

- `ordering` (`ordering.cpp`): the approximate minimum-degree ordering
  behind `inference.symbolic.ccolamd_ordering`.
- `solve_native` (`solve_native.cpp`): the host engine's sweeps
  (`inference.kernels_np`, `IncrementalEngine(backend="numpy")`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict

from gtsam_petercdev_torch.ops.build import BUILD_DIR, CSRC

HOST_SRC = os.path.join(CSRC, "host")

# library name -> source file in csrc/host/
SOURCES = {
    "ordering": "ordering.cpp",
    "solve_native": "solve_native.cpp",
}

CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]

_P = ctypes.c_void_p
_L = ctypes.c_int64
_D = ctypes.c_double
# library -> {entry point: (argtypes, restype)}
_SIGNATURES = {
    "ordering": {
        # n, n_edges, edges, cmember (or None), perm_out
        "gtsam_amd_order": ([_L, _L, _P, _P, _P], _L),
    },
    "solve_native": {
        # n_cap, parent, alive, nf, ns, nfr, nsr, pL, pLinv, pW, pY, fro_off,
        # sep_off, fro_buf, sep_buf, x, d, xcap, seeds, n_seeds, threshold,
        # dirty, seed_mask, scratch
        "wildfire_sweep": ([_L] + [_P] * 15 + [_L, _L, _P, _L, _D, _P, _P, _P], _L),
        # Fm, gm, B, m, nf, d, eps, L, Linv, W, y, U, ug, work
        "chol_bucket": ([_P, _P, _L, _L, _L, _L, _D] + [_P] * 7, _L),
        # pool, gp, d, n_levels, nf, ns, B, boff, goff, ext, extg, payL, payLinv,
        # payW, payY, payU, payUg, eps, work
        "eliminate_sweep": ([_P, _P, _L, _L] + [_P] * 13 + [_D, _P], _L),
        # dst, rows, vals, n, w, trash
        "scatter_add_rows": ([_P, _P, _P, _L, _L, _L], None),
    },
}

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}


def cxx_path() -> str:
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found: the port's host libraries build with g++")
    return path


def library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(os.path.join(HOST_SRC, SOURCES[name]), "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build_all() -> None:
    """Compile every host library that is not built yet, one g++ per source,
    all in parallel; raise if any fails."""
    cxx = cxx_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name, src in SOURCES.items():
        out = library_path(name)
        if os.path.exists(out):
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [cxx] + CXX_FLAGS + ["-o", tmp, os.path.join(HOST_SRC, src)]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, out, tmp, p in procs:
        _, stderr = p.communicate()
        if p.returncode != 0:
            failed.append(f"{name}: g++ exit {p.returncode}\n{stderr}")
            os.unlink(tmp)
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees old or new
    if failed:
        raise RuntimeError("host library build failed:\n" + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The host library `name`, built on first use; argtypes declared."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            if not os.path.exists(library_path(name)):
                build_all()
            lib = ctypes.CDLL(library_path(name))
            for entry, (argtypes, restype) in _SIGNATURES[name].items():
                fn = getattr(lib, entry)
                fn.argtypes = argtypes
                fn.restype = restype
            _LOADED[name] = lib
        return lib
