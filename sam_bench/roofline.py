"""Least device time of the multifrontal sweep's bucket kernels (K1-K4),
counted at each clique's own frontal and separator sizes under the plan the
port chose (so the padding of a bucket's shape shows as lost share).

Copied from the port's chip-check script (`factor_cost`, `blocks_cost`,
`backsolve_cost`) with that change: each input byte read once and each
output byte written once. A factor launch reads the frontal rows of F
([F11 | F12], F21 being F12's transpose), F22 and g, and writes L, the
inverse diagonal blocks, W, y, U, ug and a pivot count; a back-solve reads L
below its diagonal blocks, those inverses, W, y and the separator's x, and
writes x. A launch's least time is max(bytes / MEM_BPS, flops / peak).

Peaks: NVIDIA H100 SXM data sheet, dense: 3.35 TB/s HBM3, 67 TFLOP/s in
float64 on the tensor cores and in float32 outside them, at the 700 W
power limit; a card set lower reads a lower share."""

from __future__ import annotations

import re

import numpy as np

MEM_BPS = 3.35e12
PEAK_FLOPS = {"float64": 67e12, "float32": 67e12}
ITEMSIZE = {"float64": 8, "float32": 4}
# device names of the port's bucket kernels: K1 (factor, solve, Schur
# stage), K3 (shared memory, then the Schur stage), K4 (block pool), K2
KERNELS = ("factor_kernel", "solve_kernel", "schur_update_kernel",
           "partial_cholesky_smem_kernel", "partial_cholesky_blocks_kernel",
           "backsolve_warp_kernel", "backsolve_cluster_kernel")
_KERNEL_RE = re.compile(r"\b(" + "|".join(KERNELS) + r")\b")
# the port's launch counters of a bucket's factor route (one a bucket a sweep)
FACTOR_ROUTES = ("partial_cholesky", "partial_cholesky_smem", "partial_cholesky_blocks")


def is_bucket_kernel(name: str) -> bool:
    return bool(_KERNEL_RE.search(name))


def factor_cost(fd: int, sd: int, diag: int, itemsize: int):
    """(bytes, flops) of one clique's partial Cholesky; diag = sum of the
    squared frontal variable dims (the inverse diagonal blocks)."""
    m = fd + sd
    nbytes = itemsize * (fd * m + sd * sd + m + fd * fd + diag + fd * sd + fd + sd * sd + sd) + 4
    flops = fd ** 3 / 3.0 + fd * fd * sd + fd * sd * sd
    return nbytes, flops


def backsolve_cost(fd: int, sd: int, diag: int, itemsize: int):
    lower = (fd * fd - diag) // 2  # L below its diagonal blocks
    nbytes = itemsize * (lower + diag + fd * sd + fd + sd + fd)
    flops = 2.0 * fd * sd + 2.0 * lower + 2.0 * diag
    return nbytes, flops


def sweep_bound_s(plan, var_dims: np.ndarray, dtype: str) -> float:
    """Least seconds of one sweep: a factor and a back-solve launch a bucket."""
    item, peak = ITEMSIZE[dtype], PEAK_FLOPS[dtype]
    total = 0.0
    for level in plan.levels:
        for bk in level:
            fb = ff = bb = bf = 0.0
            for cid in bk.cliques:
                c = plan.cliques[cid]
                df = var_dims[plan.perm[np.asarray(c.frontal, dtype=np.int64)]]
                ds = var_dims[plan.perm[np.asarray(c.separator, dtype=np.int64)]]
                fd, sd, diag = int(df.sum()), int(ds.sum()), int((df * df).sum())
                b, f = factor_cost(fd, sd, diag, item)
                fb, ff = fb + b, ff + f
                b, f = backsolve_cost(fd, sd, diag, item)
                bb, bf = bb + b, bf + f
            total += max(fb / MEM_BPS, ff / peak) + max(bb / MEM_BPS, bf / peak)
    return total


def n_buckets(plan) -> int:
    return sum(len(level) for level in plan.levels)


def var_dims(type_counts: dict, type_dims: dict) -> np.ndarray:
    """Tangent dim of every variable, types in sorted-name order (the
    port's global enumeration)."""
    return np.concatenate([np.full(type_counts[t], type_dims[t], dtype=np.int64)
                           for t in sorted(type_counts)])
