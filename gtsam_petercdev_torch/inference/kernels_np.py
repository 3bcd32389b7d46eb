"""Host twins of the bucket partial Cholesky and back-substitution on numpy
arrays.

Port of gtsam_petercdev_tpu/inference/kernels_np.py. The math is the bucket
kernels' (gtsam/base/cholesky.cpp:106-159 semantics: a pivot <= eps is
clamped to eps and counted).

The route is chosen by dtype: float64 goes through the native scalar core
(`csrc/host/solve_native.cpp` chol_bucket, the port's g++ build of the JAX
package's source); every other dtype, and every back-substitution, through
the plain PyTorch versions of `inference/kernels.py` on CPU views of the
arrays. The JAX module's numpy block loop is that plain version's twin, so
the port does not carry a second copy of it. The JAX module also has a
LAPACK route for large float32 fronts that falls back to the loop when a
pivot is not positive; the port chooses no route by another one's failure,
so it has no LAPACK route. The host engine (`IncrementalEngine(
backend="numpy")`, float64 only) runs the native sweeps over whole plans and
calls neither function.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from gtsam_petercdev_torch.inference import kernels
from gtsam_petercdev_torch.ops import build_host


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


def partial_cholesky(Fm, gm, nf: int, d: int, eps=1e-10):
    """[B, m, m] bucket -> dict with L [B, fd, fd], Linv [B, nf, d, d],
    W [B, fd, sd], y [B, fd], U [B, sd, sd], ug [B, sd] (numpy arrays) and
    bad (clamped pivots, an int). float64 runs the native core, other
    dtypes the plain PyTorch version."""
    if Fm.dtype == np.float64:
        return _partial_cholesky_native(Fm, gm, nf, d, eps)
    out = kernels.partial_cholesky(torch.from_numpy(np.ascontiguousarray(Fm)),
                                   torch.from_numpy(np.ascontiguousarray(gm)), nf, d, eps)
    return {k: (int(v) if k == "bad" else v.numpy()) for k, v in out.items()}


def _partial_cholesky_native(Fm, gm, nf, d, eps):
    lib = build_host.load("solve_native")
    B, m, _ = Fm.shape
    fd = nf * d
    sd = m - fd
    Fm = np.ascontiguousarray(Fm, dtype=np.float64)
    gm = np.ascontiguousarray(gm, dtype=np.float64)
    L = np.empty((B, fd, fd))
    Linv = np.empty((B, nf, d, d))
    W = np.empty((B, fd, sd))
    y = np.empty((B, fd))
    U = np.empty((B, sd, sd))
    ug = np.empty((B, sd))
    work = np.empty(m * m + m)
    bad = lib.chol_bucket(_ptr(Fm), _ptr(gm), B, m, nf, d, float(eps), _ptr(L), _ptr(Linv),
                          _ptr(W), _ptr(y), _ptr(U), _ptr(ug), _ptr(work))
    return dict(L=L, Linv=Linv, W=W, y=y, U=U, ug=ug, bad=int(bad))


def backsolve_bucket(L, Linv, rhs, nf: int, d: int):
    """Solve L^T x = rhs per clique of the bucket [B, fd] (a new array)."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return kernels.backsolve_bucket(t(L), t(Linv), t(rhs), nf, d).numpy()
