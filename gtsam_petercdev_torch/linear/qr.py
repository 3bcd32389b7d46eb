"""Exact QR elimination: equality-constrained and rank-deficient solves.

Port of gtsam_petercdev_tpu/linear/qr.py. The reference eliminates sigma==0
(Constrained) noise rows with a staggered host QR: infinite-weight rows act
as exact Gaussian-elimination pivots while finite rows are orthogonalized
around them (gtsam/linear/NoiseModel.cpp:503, JacobianFactor.cpp:804-894).
Here the SAME problem — min ||A x - b||^2 subject to C x = d — is solved by
the nullspace method, in dense batched library algebra on the tensors'
device:

    C^T = Q R   (one full QR; Q = [Q1 | Z], Z spans null(C))
    x0  = pinv(C) d                  (minimum-norm particular solution)
    z   = argmin ||A (x0 + Z z) - b||  via  (Z^T (H + lam D) Z) z = Z^T (g - H x0)
    x   = x0 + Z z

The constraint holds exactly (to factorization roundoff, ~1e-14 in f64)
instead of to 1/mu^2 as in the penalty treatment.

`qr_solve` is the rank-revealing least-squares solve the reference reaches
through EliminateQR on rank-deficient systems (JacobianFactor.cpp:804): the
minimum-norm solution instead of IndeterminantLinearSystemException.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gtsam_petercdev_torch.core import manifold
from gtsam_petercdev_torch.linear import solve as linsolve
from gtsam_petercdev_torch.nonlinear.factor_graph import LinearizedGraph


def has_constraints(lg: LinearizedGraph) -> bool:
    return any(
        lb.constrained_mask is not None and lb.constrained_mask.any() for lb in lg.batches
    )


def _global_index(lb, off):
    """Per slot, the [N, dim_k] global columns of a batch's blocks."""
    out = []
    for k, t in enumerate(lb.var_types):
        dk = manifold.get(t).dim
        base = off[t] + linsolve._rows(lb, k) * dk
        out.append(base[:, None] + torch.arange(dk, device=base.device)[None, :])
    return out


def assemble_constrained(lg: LinearizedGraph):
    """Split the linearized graph into (H, g) over least-squares rows and a
    dense constraint system (C, d) over sigma==0 rows.

    Constraint row indices are planned on the host from the numpy masks, so
    C has a fixed [nc, D] shape."""
    off, D = linsolve.offsets(lg)
    b0 = lg.batches[0].b
    dtype, dev = b0.dtype, b0.device
    H = torch.zeros((D, D), dtype=dtype, device=dev)
    g = torch.zeros((D,), dtype=dtype, device=dev)

    # host plan: one global row id per constrained (factor, row) pair
    nc = 0
    plans = []  # per batch: None | [N, d] int64 global constraint row (-1 = LS row)
    for lb in lg.batches:
        m = lb.constrained_mask
        if m is None or not m.any():
            plans.append(None)
            continue
        rowid = np.full(m.shape, -1, dtype=np.int64)
        rowid[m] = nc + np.arange(int(m.sum()))
        nc += int(m.sum())
        plans.append(rowid)

    C = torch.zeros((nc, D), dtype=dtype, device=dev)
    d_vec = torch.zeros((nc,), dtype=dtype, device=dev)

    for lb, rowid in zip(lg.batches, plans):
        gidx = _global_index(lb, off)
        if rowid is None:
            A, b = lb.A, lb.b
        else:
            # zero the constrained rows out of the least-squares part
            keep = torch.as_tensor(~lb.constrained_mask, device=dev).to(dtype)
            A = tuple(Ak * keep[:, :, None] for Ak in lb.A)
            b = lb.b * keep
            # scatter the constrained rows into C, d
            fsel, rsel = np.nonzero(lb.constrained_mask)
            rows_g = torch.as_tensor(rowid[fsel, rsel], device=dev)
            fs, rs = torch.as_tensor(fsel, device=dev), torch.as_tensor(rsel, device=dev)
            for k in range(len(lb.var_types)):
                C.index_put_((rows_g[:, None], gidx[k][fs]), lb.A[k][fs, rs, :], accumulate=True)
            d_vec.index_put_((rows_g,), lb.b[fs, rs], accumulate=True)
        for k in range(len(lb.var_types)):
            g.index_put_((gidx[k],), lb.sign * torch.einsum("ndk,nd->nk", A[k], b),
                         accumulate=True)
            for l in range(len(lb.var_types)):
                blk = lb.sign * torch.einsum("ndi,ndj->nij", A[k], A[l])
                H.index_put_((gidx[k][:, :, None], gidx[l][:, None, :]), blk, accumulate=True)
    return H, g, C, d_vec


def solve_lse(
    H: torch.Tensor,
    g: torch.Tensor,
    C: torch.Tensor,
    d: torch.Tensor,
    lam=0.0,
    diagonal_damping: bool = False,
):
    """Damped equality-constrained normal-equation solve (nullspace method).

    Returns (x, lin_decrease) with C x = d exact and x minimizing the damped
    least-squares model on the constraint manifold. Where the reduced
    Cholesky fails, x is NaN (as the JAX package's cho_factor leaves it) and
    the caller's error test rejects the step."""
    D = H.shape[0]
    nc = C.shape[0]
    Qf, _ = torch.linalg.qr(C.T, mode="complete")  # C^T [D, nc] = Qf [D, D] @ [R; 0]
    Z = Qf[:, nc:]
    # particular solution by a masked pseudo-inverse: redundant equality
    # constraints (two NonlinearEquality factors on one key) make the
    # triangular factor singular; the SVD pinv stays finite and picks the
    # minimum-norm feasible point. Dependent rows conservatively SHRINK the
    # optimized subspace Z (still feasible, slightly restricted), as the
    # reference's staggered QR treats them as zero pivots (NoiseModel.cpp:503).
    U_, S_, Vh_ = torch.linalg.svd(C, full_matrices=False)
    tol = torch.finfo(H.dtype).eps * max(D, nc) * 10.0
    Sinv = torch.where(S_ > tol * torch.max(S_), 1.0 / torch.clamp(S_, min=tol),
                       torch.zeros_like(S_))
    x0 = Vh_.T @ (Sinv * (U_.T @ d))
    if diagonal_damping:
        damp = torch.diag(torch.diagonal(H))
    else:
        damp = torch.eye(D, dtype=H.dtype, device=H.device)
    Hz = Z.T @ (H + lam * damp) @ Z
    gz = Z.T @ (g - H @ x0)
    eye = torch.eye(Hz.shape[0], dtype=H.dtype, device=H.device)
    L, info = torch.linalg.cholesky_ex(Hz + 1e-12 * eye)
    z = torch.cholesky_solve(gz[:, None], L)[:, 0]
    z = torch.where(info == 0, z, torch.full_like(z, float("nan")))
    x = x0 + Z @ z
    lin_dec = torch.dot(g, x) - 0.5 * torch.dot(x, H @ x)
    return x, lin_dec


def solve_constrained_dense(lg: LinearizedGraph, lam=0.0, diagonal_damping: bool = False):
    """Full pipeline: assemble + LSE solve -> (VectorValues delta, lin_dec)."""
    H, g, C, d = assemble_constrained(lg)
    x, lin_dec = solve_lse(H, g, C, d, lam, diagonal_damping)
    return linsolve.unflatten_delta(lg, x), lin_dec


def qr_solve(A: torch.Tensor, b: torch.Tensor, rcond: Optional[float] = None):
    """Rank-revealing least squares min ||A x - b|| (EliminateQR analog):
    the minimum-norm solution, also of a rank-deficient A.

    The SVD pseudo-inverse on every device (`torch.linalg.lstsq` on CUDA
    offers only gels, which needs a full-rank A). rcond (singular values
    below rcond * the largest are dropped) defaults to eps * max(m, n),
    numpy's and JAX's."""
    vec = b.ndim == A.ndim - 1
    B = b[..., None] if vec else b
    m, n = A.shape[-2:]
    if rcond is None:
        rcond = torch.finfo(A.dtype).eps * max(m, n)
    U, S, Vh = torch.linalg.svd(A, full_matrices=False)
    keep = S > rcond * S[..., :1]
    Sinv = torch.where(keep, 1.0 / torch.where(keep, S, torch.ones_like(S)), torch.zeros_like(S))
    x = Vh.mT @ (Sinv[..., None] * (U.mT @ B))
    return x[..., 0] if vec else x
